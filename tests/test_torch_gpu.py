"""Card tests of the port: the merge-insert CUDA kernel against its plain
PyTorch twin on the same CUDA tensors — one pass, a build, an extend build
onto a non-empty base, and a streamed build — the query tiers (pair index,
run tier, a chunked deep prefix cache, ``RleBWT``'s policy), the H-M and
doubling merges and two gloo ranks sharing the card, each against the same
functions on the CPU; radix-2 builds (kernel == radix 1 == plain), an
append onto a large base at the radix the rule picks (2) against radix 1,
and one radix-2 step against the CPU's; ``lf_pair`` (the radix-2 column pair)
against its plain twin with slots on tile edges, full tiles, empty tiles,
tiles at the edges of their buckets, clustered and many overfull tiles,
N = 1, no read active in the second column, slots past 2^30 and 1.1M
reads, its tile rule, called again and again with ``lf_stage`` on one scratch, on
two streams at once, and bad inputs refused; the profiling timers and trace, the
session-health memory probe, and the build entry's spans on the profiler's
clock; the LF-step kernels (``lf_stage``, the four ``lf_walk`` walks)
against their plain twins on the same CUDA tensors at edge shapes, and
builds, extends, streamed builds, extract and locate through them against
the CPU's plain path; the query kernels
(``kmer_ranges_packed``, ``kmer_counts_pair``) against their plain twins
on the same CUDA tensors at edge shapes (B = 1, B = 0, every query absent,
n % 128 == 0, caches 6^8 / 6^9 / 6^11, 1.1M queries, warps that mix
queries that stop early with full ones and one-symbol tails, batch sizes
at the edges of the kernels' lane groups, warps and blocks, with nothing
written past the batch), ``count_batch``'s split of short queries, and
bad inputs refused; ``lf_stage`` on two streams of one card at once (from
one host thread and from two), and a build, an extend and both query
tiers with every tensor on ``cuda:1`` while ``cuda:0`` is the current
device (skipped below two cards). Bit-exact throughout
(tolerance 0: every output is an integer).

Marked ``gpu``; without a card every test skips (the decision is made in a
fixture, never at import time). This file imports no jax, so it runs on a
machine with only torch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

import functools

import numpy as np
import pytest
import torch

from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
from rust_msbwt_tpu_torch.ops import rank
from rust_msbwt_tpu_torch.ops.bcr import (
    build_msbwt,
    build_msbwt_with_index,
    encode_reads,
    index_from_symbols,
)
from rust_msbwt_tpu_torch.ops import merge_insert as merge_mod
from rust_msbwt_tpu_torch.ops.merge_insert import merge_insert, merge_insert_slots
from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
from rust_msbwt_tpu_torch.ops.rle import encode_symbols, runs_from_symbols
from rust_msbwt_tpu_torch.ops.run_rank import (
    build_kmer_cache_runs,
    build_run_index,
    count_kmers_runs,
)
from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(n_old, n_ins, n_cap, seed, frac_active=1.0, clustered=False):
    r = np.random.default_rng(seed)
    old = np.full(n_cap, 7, np.uint8)
    old[:n_old] = r.integers(0, 6, n_old)
    active = r.random(n_ins) < frac_active
    m = int(active.sum())
    if clustered:
        q = n_old // 3 + np.arange(n_ins)
    else:
        q = r.choice(n_old + m, size=n_ins, replace=False)
    v = r.integers(0, 6, n_ins)
    return old, q.astype(np.int32), v.astype(np.uint8), active


@pytest.mark.parametrize(
    "n_old,n_ins,n_cap,frac,clustered",
    [
        (0, 5, 64, 1.0, False),            # one partial bin
        (1000, 300, 1300, 1.0, False),      # n_cap % 128 != 0
        (4096, 1024, 5120, 1.0, False),     # n_cap % 128 == 0
        (100_000, 1000, 101_037, 1.0, False),  # sparse
        (100_000, 4000, 104_000, 0.5, False),  # masked
        (200_000, 20_000, 220_000, 1.0, True),  # clustered: dense bins
        (3_000_000, 70_000, 3_070_000, 1.0, False),  # many tiles
    ],
)
def test_kernel_matches_plain(cuda, n_old, n_ins, n_cap, frac, clustered):
    old, q, v, active = _case(n_old, n_ins, n_cap, n_old + n_ins, frac, clustered)
    if frac < 1.0:  # masked: slots only need to be valid for the active ones
        n_cap = n_old + int(active.sum())
        old = old[:n_cap]
    _check_kernel(cuda, old, q, v, active)


def _check_kernel(cuda, old, q, v, active):
    """One pass through the kernel and through the plain version on the
    same CUDA tensors: equal, one launch, m == the active count."""
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(cuda)  # noqa: E731
    args = (t(old), t(q), t(v), t(active))
    before = merge_insert.launches
    new_k, tab_k, m_k = merge_insert(*args)
    new_p, tab_p, m_p = merge_insert_slots(*args)
    torch.cuda.synchronize()
    assert merge_insert.launches == before + 1
    assert int(m_k) == int(m_p) == int(active.sum())
    assert torch.equal(new_k, new_p)
    assert torch.equal(tab_k, tab_p)


EDGE_KINDS = ["unsorted", "inactive", "full_tile", "boundaries", "copy", "small",
              "ragged", "under"]


def _edge_case(kind, seed, tile):
    """Shapes at the kernel's tile edges of ``tile`` positions (also run on
    the CPU by tests/test_torch_merge.py and on the card by chip_smoke.py):
    ``(buf, q, v, active)`` with active slots distinct and < n, in no order."""
    r = np.random.default_rng(seed)
    n, inactive_q = {"unsorted": 3 * tile, "inactive": 2 * tile + 300,
                     "full_tile": 3 * tile + 50, "boundaries": 4 * tile + 3,
                     "copy": 2 * tile + 77, "small": 1000, "ragged": 3 * tile + 45,
                     "under": 2 * tile - 1}[kind], []
    if kind == "full_tile":  # tile 1 is inserts only
        rest = np.setdiff1d(np.arange(n), np.arange(tile, 2 * tile))
        slots = np.concatenate([np.arange(tile, 2 * tile), r.choice(rest, 200, replace=False)])
    elif kind == "boundaries":
        edges = [k * tile + d for k in range(1, 5) for d in (-1, 0, 1)]
        slots = np.array(sorted({0, n - 1, *[e for e in edges if e < n]}))
    elif kind == "copy":
        slots = np.zeros(0, np.int64)
    else:
        slots = r.choice(n, {"small": 100, "ragged": 2000, "under": 1500}.get(kind, 3000),
                         replace=False)
    if kind == "inactive":  # stale slots: equal to active ones, at or past n
        inactive_q = np.concatenate([slots[:100], n + np.arange(100),
                                     np.full(100, 2**31 - 1)])
    q = np.concatenate([slots, inactive_q]).astype(np.int32)
    active = np.arange(q.size) < slots.size
    perm = r.permutation(q.size)
    q, active = q[perm], active[perm]
    v = r.integers(0, 6, q.size).astype(np.uint8)
    n_old = n - slots.size - int(r.integers(0, 40))
    buf = np.full(n, 7, np.uint8)
    buf[:n_old] = r.integers(0, 6, n_old)
    return buf, q, v, active


@pytest.mark.parametrize("kind", EDGE_KINDS)
def test_kernel_tile_edges_match_plain(cuda, kind):
    from rust_msbwt_tpu_torch import _kernels

    tile = _kernels.load().msbwt_merge_tile()
    _check_kernel(cuda, *_edge_case(kind, len(kind), tile))


def test_build_on_card_makes_no_insert_maps(cuda, monkeypatch):
    """The stage loop on the card goes through the kernel alone: no insert
    or shift map is made."""
    def no_maps(*a, **k):
        raise AssertionError("insert_maps called on the kernel path")

    monkeypatch.setattr(merge_mod, "insert_maps", no_maps)
    reads, lengths = _ragged(500, 31)
    before = merge_insert.launches
    idx, _ = build_msbwt_with_index(reads, lengths, device=cuda)
    assert merge_insert.launches > before
    assert idx.n == int(lengths.sum()) + 500


def test_kernel_rejects_bad_input(cuda):
    old = torch.zeros(256, dtype=torch.uint8, device=cuda)
    q = torch.zeros(8, dtype=torch.int32, device=cuda)
    v = torch.zeros(8, dtype=torch.uint8, device=cuda)
    active = torch.zeros(8, dtype=torch.bool, device=cuda)
    with pytest.raises(TypeError):
        merge_insert(old, q.long(), v, active)
    with pytest.raises(ValueError):
        merge_insert(old, q, v[:4], active)
    with pytest.raises(ValueError):
        merge_insert(old, q, v, active.cpu())
    with pytest.raises(ValueError):  # not on a 16-byte boundary
        merge_insert(old[1:], q, v, active)


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_build_kernel_matches_plain(cuda, sorted_insert):
    r = np.random.default_rng(17)
    reads_l = [r.integers(1, 6, r.integers(1, 60)).astype(np.uint8)
               for _ in range(3000)]
    reads, lengths = encode_reads(reads_l)
    idx_k, pk = build_msbwt_with_index(reads, lengths, sorted_insert, device=cuda)
    idx_p, pp = build_msbwt_with_index(reads, lengths, sorted_insert, device=cuda,
                                       merge=merge_insert_slots)
    assert torch.equal(idx_k.bwt, idx_p.bwt)
    assert torch.equal(pk.table, pp.table)
    assert torch.equal(idx_k.occ, idx_p.occ)


def _ragged(n, seed):
    r = np.random.default_rng(seed)
    return encode_reads([r.integers(1, 6, r.integers(1, 60)).astype(np.uint8)
                         for _ in range(n)])


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_extend_kernel_matches_plain(cuda, sorted_insert):
    base_reads, base_lens = _ragged(2000, 23)
    base, base_packed = build_msbwt_with_index(base_reads, base_lens, device=cuda)
    reads, lengths = _ragged(1500, 24)
    out = {}
    for name, merge in (("kernel", merge_insert), ("plain", merge_insert_slots)):
        before = merge_insert.launches
        out[name] = build_msbwt_with_index(
            reads, lengths, sorted_insert, base.bwt[: base.n], 2000,
            device=cuda, merge=merge)
        launched = merge_insert.launches - before
        assert launched > 0 if name == "kernel" else launched == 0
    (idx_k, pk), (idx_p, pp) = out["kernel"], out["plain"]
    assert torch.equal(idx_k.bwt, idx_p.bwt)
    assert torch.equal(pk.table, pp.table)
    assert idx_k.n == base.n + int(lengths.sum()) + 1500


def test_streamed_build_kernel_matches_plain(cuda):
    reads, lengths = _ragged(3000, 25)
    b = StreamingBuilder(device=cuda)
    before = merge_insert.launches
    for i in range(0, 3000, 700):
        b.add_batch(reads[i: i + 700], lengths[i: i + 700])
    assert merge_insert.launches > before
    idx_p, _ = build_msbwt_with_index(reads, lengths, device=cuda,
                                      merge=merge_insert_slots)
    assert torch.equal(b.finish(device_out=True), idx_p.bwt[: idx_p.n])


def _query_case(n_reads, read_len, seed):
    """A BWT of reads from a random genome (built on the CPU) and 21-mers
    of ragged lengths drawn from the reads, plus random ones."""
    r = np.random.default_rng(seed)
    genome = r.integers(1, 6, 2000).astype(np.uint8)
    st = r.integers(0, genome.size - read_len + 1, n_reads)
    reads = genome[st[:, None] + np.arange(read_len)[None, :]]
    dec = build_msbwt(reads, np.full(n_reads, read_len, np.int32), device="cpu")
    rows, offs = r.integers(0, n_reads, 3000), r.integers(0, read_len - 20, 3000)
    kmers = reads[rows[:, None], offs[:, None] + np.arange(21)[None, :]]
    kmers[-300:] = r.integers(0, 6, (300, 21))
    lengths = r.integers(1, 22, 3000).astype(np.int32)
    kmers[np.arange(21)[None, :] < (21 - lengths)[:, None]] = 0
    return dec, kmers, lengths


# 255 x 100 bp -> n = 25,755; 256 x 99 bp -> n = 25,600 = 200 x 128
@pytest.mark.parametrize("n_reads,read_len", [(255, 100), (256, 99)])
@pytest.mark.parametrize("cache_k", [0, 3])
def test_pair_tier_matches_cpu(cuda, n_reads, read_len, cache_k):
    dec, kmers, lengths = _query_case(n_reads, read_len, n_reads)
    out = {}
    for dev in ("cpu", cuda):
        idx, packed = index_from_symbols(torch.from_numpy(dec).to(dev))
        pair = build_pair_index(idx)
        cache = (rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, cache_k)
                 if cache_k else None)
        out[str(dev)] = (pair.table2.cpu(), pair.dmat.cpu(),
                         count_kmers_pair(pair, kmers, lengths, cache=cache, cache_k=cache_k))
    (t_c, d_c, n_c), (t_g, d_g, n_g) = out["cpu"], out[str(cuda)]
    assert torch.equal(t_c, t_g) and torch.equal(d_c, d_g)
    assert np.array_equal(n_c, n_g)


@pytest.mark.parametrize("cache_k", [0, 3])
def test_run_tier_matches_cpu(cuda, cache_k):
    dec, kmers, lengths = _query_case(300, 60, 5)
    syms, lens = runs_from_symbols(dec)
    out = {}
    for dev in ("cpu", cuda):
        ridx = build_run_index(syms, lens, device=dev)
        cache = build_kmer_cache_runs(ridx, cache_k) if cache_k else None
        out[str(dev)] = (ridx.table.cpu(),
                         count_kmers_runs(ridx, kmers, lengths, cache=cache, cache_k=cache_k),
                         None if cache is None else torch.stack([cache.lo, cache.hi]).cpu())
    (t_c, n_c, c_c), (t_g, n_g, c_g) = out["cpu"], out[str(cuda)]
    assert torch.equal(t_c, t_g) and np.array_equal(n_c, n_g)
    assert cache_k == 0 or torch.equal(c_c, c_g)


def test_deep_cache_chunked_matches_cpu(cuda, monkeypatch):
    dec, *_ = _query_case(100, 50, 9)
    monkeypatch.setattr(rank, "_CACHE_LEVEL_CHUNK", 6**4 + 3)
    caches = []
    for dev in ("cpu", cuda):
        idx = rank.build_occ_index(torch.from_numpy(dec).to(dev))
        caches.append(rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 7))
    assert torch.equal(caches[0].lo, caches[1].lo.cpu())
    assert torch.equal(caches[0].hi, caches[1].hi.cpu())


def test_rle_bwt_policy_on_card(cuda, monkeypatch):
    """Pair + a 6^3 cache picked by the policy (threshold patched) on the
    card; the counts equal the CPU engine's."""
    dec, kmers, lengths = _query_case(200, 80, 11)
    monkeypatch.setattr(RleBWT, "PAIR_AUTO_MIN_SYMBOLS", 1)
    monkeypatch.setattr(RleBWT, "CACHE_AUTO_K", 3)
    counts = []
    for dev in ("cpu", cuda):
        bwt = RleBWT(device=dev)
        bwt.load_vector(encode_symbols(dec))
        counts.append(bwt.count_kmers(kmers, lengths))
        assert bwt._pair_index is not None and bwt._cache_k == 3
    assert np.array_equal(counts[0], counts[1])


def _merge_parts(seed, d, n_reads=300):
    r = np.random.default_rng(seed)
    reads_l = [r.integers(1, 6, r.integers(1, 80)).astype(np.uint8) for _ in range(n_reads)]
    reads_l += reads_l[:20]  # identical reads across parts: the tie order
    return [build_msbwt(*encode_reads(reads_l[i::d]), device="cpu") for i in range(d)]


@pytest.mark.parametrize("fn", ["pairwise", "interleave", "multiway", "multiway_wide",
                                "kway_tree"])
def test_merges_match_cpu(cuda, fn, monkeypatch):
    """``ops.merge`` on ``cuda`` tensors == the same function on the CPU;
    the card's result stays on the card."""
    from rust_msbwt_tpu_torch.ops import merge

    parts = _merge_parts(31, 4)
    calls = {
        "pairwise": lambda ps: merge.pairwise_bwt_merge(ps[0], ps[1]),
        "interleave": lambda ps: merge.merge_interleave(ps[0], ps[1]),
        "multiway": lambda ps: merge.multiway_bwt_merge(ps, return_sources=True),
        "multiway_wide": lambda ps: merge.multiway_bwt_merge(ps, force_wide=True,
                                                             return_sources=True),
        "kway_tree": lambda ps: merge.kway_merge(ps),
    }
    if fn == "kway_tree":
        monkeypatch.setenv("MSBWT_TPU_MERGE", "tree")
    outs = []
    for dev in ("cpu", cuda):
        got = calls[fn]([torch.from_numpy(p).to(dev) for p in parts])
        got = got if isinstance(got, tuple) else (got,)
        assert all(t.device.type == torch.device(dev).type for t in got)
        outs.append([t.cpu() for t in got])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_two_gloo_ranks_share_the_card(cuda, tmp_path):
    """Two gloo ranks on ``cuda:0`` (NCCL refuses two ranks on one card):
    the sharded builds, the doubling merge and both distributed counts
    equal the single-device results on the CPU."""
    from rust_msbwt_tpu_torch.ops.merge import multiway_bwt_merge
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
    from _torch_dist_worker import run_ranks  # tests/ is on sys.path

    r = np.random.default_rng(41)
    reads, lengths = _ragged(400, 43)
    parts = _merge_parts(47, 3, 200)
    kmers = r.integers(1, 6, (300, 7)).astype(np.uint8)
    klens = r.integers(1, 8, 300).astype(np.int32)
    idx, packed = build_msbwt_with_index(reads, lengths, device="cpu")
    dec = idx.bwt[: idx.n].numpy()
    inputs = dict(reads=reads, lengths=lengths, kmers=kmers, klens=klens, decoded=dec,
                  parts=np.concatenate(parts), part_sizes=np.array([p.size for p in parts]))
    cases = ["build_tree", "build_dense", "build_ragged", "doubling", "sharded_index",
             "partitioned", "multihost"]
    ranks = run_ranks(2, cases, inputs, str(tmp_path), device="cuda:0", timeout_s=180)
    merged, srcs = multiway_bwt_merge(parts, return_sources=True, device="cpu")
    counts = count_kmers_packed(packed, kmers, klens)
    for out in ranks:
        for case in ("build_tree", "build_dense", "build_ragged", "multihost"):
            assert np.array_equal(out[f"{case}.bwt"], dec), case
        assert np.array_equal(out["doubling.bwt"], merged)
        assert np.array_equal(out["doubling.src"], srcs)
        assert np.array_equal(out["sharded_index.counts"], counts)
        assert np.array_equal(out["partitioned.counts"], counts)


def _radix_reads(kind, tile):
    """Builds whose buffer ends at a tile edge (2 tiles - 1, + 0, + 1
    positions: 1,023 reads of 31 bp and one of 30-32), a build over many
    tiles, and ragged reads (odd tails)."""
    r = np.random.default_rng(len(kind))
    if kind.startswith("edge"):
        d = int(kind[4:])
        n_reads = 2 * tile // 32 - 1
        reads_l = [r.integers(1, 6, 31).astype(np.uint8) for _ in range(n_reads)]
        reads_l.append(r.integers(1, 6, 31 + d).astype(np.uint8))
    elif kind == "many_tiles":
        reads_l = [r.integers(1, 6, 63).astype(np.uint8) for _ in range(4000)]
    else:
        reads_l = [r.integers(1, 6, r.integers(1, 60)).astype(np.uint8) for _ in range(3000)]
    return encode_reads(reads_l)


@pytest.mark.parametrize("kind,sorted_insert", [("edge-1", True), ("edge0", True),
                                                ("edge1", True), ("many_tiles", True),
                                                ("ragged", True), ("ragged", False)])
def test_radix2_build_matches_radix1_and_plain(cuda, monkeypatch, kind, sorted_insert):
    """A radix-2 build (2N slots a pass, unsorted; ``lf_pair`` a column
    pair, ``lf_group`` a column group where the ragged reads' tail leaves
    few active) through the kernels == the radix-1 build == the radix-2
    build through the plain pass and LF steps (no kernel launched); its
    passes, pairs, single columns and groups those of its schedule."""
    from rust_msbwt_tpu_torch import _kernels
    from rust_msbwt_tpu_torch.ops import bcr, lf

    reads, lengths = _radix_reads(kind, _kernels.load().msbwt_merge_tile())
    if kind.startswith("edge"):
        n = int(lengths.sum()) + lengths.size
        assert n - 2 * _kernels.load().msbwt_merge_tile() == int(kind[4:])
    out = {}
    counters = (merge_insert, lf.lf_stage, lf.lf_pair, lf.lf_group)
    for name, radix, merge in (("r2", 2, merge_insert), ("r1", 1, merge_insert),
                               ("r2_plain", 2, merge_insert_slots)):
        monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
        with monkeypatch.context() as m:
            if name == "r2_plain":
                m.setattr(bcr, "lf_stage", lambda *a, scratch=None: lf.lf_stage_plain(*a))
                m.setattr(bcr, "lf_pair", lambda *a, scratch=None: lf.lf_pair_plain(*a))
                m.setattr(bcr, "lf_group",
                          lambda *a, order=None: lf.lf_group_plain(*a, order))
            before = [c.launches for c in counters]
            idx, packed = build_msbwt_with_index(reads, lengths, sorted_insert, device=cuda,
                                                 merge=merge)
        out[name] = (idx.bwt, packed.table,
                     *(c.launches - b for c, b in zip(counters, before)))
    N, L = lengths.size, reads.shape[1]
    n_cap = int(lengths.sum()) + N
    steps = bcr.group_schedule(bcr.pair_buckets(bcr.bucket_schedule(0, N, L, n_cap, 128), L),
                               bcr.active_counts(lengths, L), N)
    ks = [k for _, k, _ in steps]
    assert out["r1"][2:] == (1 + L, L, 0, 0)
    assert out["r2"][2:] == (1 + len(ks), ks.count(1), ks.count(2), len(ks) - ks.count(1)
                             - ks.count(2))
    assert (kind == "ragged") == (out["r2"][5] > 0)  # fixed lengths: pairs only
    if kind != "ragged":
        assert out["r2"][2:5] == (1 + -(-L // 2), L % 2, L // 2)
    assert out["r2_plain"][2:] == (0, 0, 0, 0)
    for name in ("r1", "r2_plain"):
        assert torch.equal(out["r2"][0], out[name][0]) and torch.equal(out["r2"][1], out[name][1])


def test_stage_step2_on_card_matches_cpu(cuda):
    """One double-column step after stage 1 on ragged reads: every output on
    ``cuda`` equals the CPU's."""
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.lf import lf_pair

    reads, lengths = _ragged(2000, 61)
    p = bcr._prepare_build(reads, lengths, True)
    N, cap = p["N"], -(-p["n_cap"] // 128) * 128
    outs = []
    for dev in ("cpu", cuda):
        cols = torch.from_numpy(p["cols"]).to(dev)
        lens = torch.from_numpy(p["lengths"]).to(dev)
        q1 = torch.arange(N, dtype=torch.int32, device=dev)
        active = lens >= 0
        buf = torch.full((cap,), 7, dtype=torch.uint8, device=dev)
        _, table, _ = merge_insert(buf, q1, cols[1], active)
        counts = bcr._bump_counts(torch.zeros(6, dtype=torch.int32, device=dev), cols[1], active)
        res = lf_pair(2, table, cap, N, cols, lens, q1, counts, cols[1])
        outs.append([t.cpu() for t in res])
    assert all(torch.equal(a, b) for a, b in zip(*outs))


def test_profiling_on_card(cuda, tmp_path):
    """``timeit`` times the card (no faster than its memory allows);
    ``trace`` records the kernel's device time."""
    import os

    from rust_msbwt_tpu_torch.utils import profiling

    x = torch.ones(1 << 24, device=cuda)
    assert profiling.timeit(lambda: x * 2, reps=3) > 2 * x.numel() * 4 / profiling.DEFAULT_HBM_BW
    old, q, v, active = _case(100_000, 1000, 101_000, 7)
    t = lambda a: torch.from_numpy(a).to(cuda)  # noqa: E731
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("merge"):
            merge_insert(t(old), t(q), t(v), t(active))
    assert len(os.listdir(tmp_path)) == 1
    dev_us = [getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))
              for e in prof.key_averages() if "merge_tiles" in e.key]
    assert dev_us and max(dev_us) > 0


def test_session_health_on_card(cuda):
    """The memory probe counts one read and one write a pass: a healthy card
    reads above 60% of its data-sheet rate."""
    from rust_msbwt_tpu_torch.utils import profiling

    h = profiling.session_health()
    assert h["device"] == torch.cuda.get_device_name(0)
    assert h["dispatch_roundtrip_ms"] > 0
    assert h["mem_gbps"] > 0.6 * profiling.DEFAULT_HBM_BW / 1e9, h


def test_build_entry_spans_on_card(cuda):
    """One traced append, read as the benchmark reads a window
    (``portbench.trace.Trace``): the build entry's nine spans are host
    events, each once, and none of them is among the device events (where
    its device-side copy would cover the idle time inside it); they share
    the device events' clock, so the first device event that starts inside
    ``msbwt.upload`` is the stage view's host-to-device copy."""
    from torch.profiler import ProfilerActivity, profile

    from portbench.trace import OP_SPAN, Trace

    # a 2 MB stage view, so its copy lasts long next to the clocks' alignment
    rng = np.random.default_rng(29)
    reads = rng.integers(1, 5, (40_000, 100)).astype(np.uint8)
    lengths = np.full(40_000, 100, np.int32)
    idx, packed = build_msbwt_with_index(reads[:20_000], lengths[:20_000], device=cuda)
    kw = dict(base=idx.bwt[: idx.n], base_string_count=20_000, base_rot_max=101,
              base_index=packed, device=cuda)
    build_msbwt_with_index(reads[20_000:], lengths[20_000:], **kw)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(OP_SPAN):
            build_msbwt_with_index(reads[20_000:], lengths[20_000:], **kw)
            torch.cuda.synchronize()
    tr = Trace.from_profiler(prof, torch.cuda.get_device_name(0), 0.0, [], {})
    assert len(tr.spans) == 1 and len(tr.device)
    assert not [n for n in tr.device_names if n.startswith("msbwt.")]
    spans = {n: tr.cpu[i] for i, n in enumerate(tr.cpu_names) if n.startswith("msbwt.")}
    assert sorted(spans) == sorted(
        ["msbwt.build", "msbwt.prep.sort", "msbwt.prep.view", "msbwt.upload", "msbwt.stage1",
         "msbwt.buffers", "msbwt.base_counts", "msbwt.stage_loop", "msbwt.sync"])
    assert sum(n.startswith("msbwt.") for n in tr.cpu_names) == len(spans)
    a, b = spans["msbwt.upload"]
    near = np.flatnonzero((tr.device[:, 1] >= a - 1000) & (tr.device[:, 0] <= b + 1000))
    seen = [(tr.device_names[i][:40], *(tr.device[i] - a)) for i in near]  # us from the span's start
    inside = np.flatnonzero((tr.device[:, 0] >= a) & (tr.device[:, 0] <= b))
    assert len(inside), f"no device event starts inside msbwt.upload ({b - a} us): {seen}"
    first = tr.device_names[inside[np.argmin(tr.device[inside, 0])]]
    assert "Memcpy HtoD" in first, (first, seen)


# --- the LF-step kernels (ops/lf.py, csrc/lf.cu) ----------------------------

LF_STAGE_KINDS = ["one", "inactive", "terminal", "last_bin", "ragged"]


def lf_stage_case(kind, seed, N=None):
    """Inputs of one ``lf_stage`` column, from a seed (also run on the CPU
    by tests/test_torch_lf.py against a numpy oracle): a symbol buffer of n
    symbols (the column's table is its packed table), the stage view of
    ragged reads, a carry and a column j. ``one``: N = 1; ``inactive``: j
    past every read; ``terminal``: n % 128 == 0 and a third of the slots at
    P == n (the terminal row); ``last_bin``: every P in the last, partial
    bin; ``ragged``: anything else."""
    r = np.random.default_rng(seed)
    n = {"terminal": 1024, "last_bin": 1000}.get(kind, 777)
    N = N or (1 if kind == "one" else 300)
    L = 12
    lengths = r.integers(1, L - 1 if kind == "inactive" else L + 1, N).astype(np.int32)
    j = L + 1 if kind == "inactive" else int(r.integers(2, L + 2))
    P = r.integers(n // 128 * 128 if kind == "last_bin" else 0, n + 1, N)
    if kind == "terminal":
        P[::3] = n
    return dict(buf=r.integers(0, 6, n).astype(np.uint8), j=j,
                nst=int(r.integers(N, 2 * N + 1)),
                cols=r.integers(0, 6, (L + 2, N)).astype(np.uint8), lengths=lengths,
                P=P.astype(np.int32), counts=r.integers(0, 50, 6).astype(np.int32),
                prev_v=r.integers(0, 6, N).astype(np.uint8))


def lf_stage_args(case, dev):
    """``lf_stage``'s arguments for a case, on ``dev``."""
    from rust_msbwt_tpu_torch.ops.merge_insert import packed_table_plain

    t = lambda k: torch.from_numpy(case[k]).to(dev)  # noqa: E731
    return (case["j"], packed_table_plain(t("buf")), case["nst"], t("cols"), t("lengths"),
            t("P"), t("counts"), t("prev_v"))


# lf_pair cases: slots on tile edges, a dense run that fills every tile it
# covers (128 tiles at once, each past its bucket), two tiles with the ones
# between empty (the bitmap path), ~10 slots a tile over 200 tiles, tiles
# holding bucket - 1, bucket, bucket + 1, 128, 129 and 2 bucket + 1 slots, runs of
# consecutive slots across tile edges (as coverage gives), 32 tiles of 130
# to 300 slots, N = 1, no read active in column j + 1 (m2 = 0), ragged
# reads; "huge_c" (CPU only: slots past 2^30 from the C array, each old
# position clamped to cap, outside the kernel's tiles) and "past_2_30"
# (card only: a buffer of 2^30 + 2^17 symbols) put the slots past 2^30
LF_PAIR_KINDS = ["tile_edges", "one_tile", "empty_tiles", "sparse", "bucket_edges",
                 "clustered", "many_big", "one", "no_second", "ragged"]
PAIR_BUCKET = 128  # places of a tile's own bucket (lf.cu kBucket; the card reads the library's)


def pair_tile_rule(N, cap):
    """lf_pair's slot tile for N reads and a capacity cap, as lf.cu's
    ``pair_shift`` picks it: the largest power of two from 128 to 32K
    positions with N * tile <= 64 * (cap + 1) (at most 64 slots a tile on
    average)."""
    s = 15
    while s > 7 and (N << s) > 64 * (cap + 1):
        s -= 1
    return 1 << s


def pair_tile():
    """lf_pair's slot tile as its kernel library gives it: a function of
    (N, cap), as ``pair_tile_rule``."""
    from rust_msbwt_tpu_torch import _kernels

    lib = _kernels.load()
    return lambda N, cap: lib.msbwt_lf_pair_tile(N, cap)


def pair_bucket():
    """Places of an lf_pair tile's own bucket, as its kernel library gives
    them."""
    from rust_msbwt_tpu_torch import _kernels

    return _kernels.load().msbwt_lf_pair_bucket()


def lf_pair_case(kind, seed, N=None, *, tile, bucket=PAIR_BUCKET):
    """Inputs of one ``lf_pair`` column pair j, j + 1 (j = 4), from a seed
    (also run on the CPU by tests/test_torch_radix.py against a numpy
    oracle). The buffer is n symbols of A, so column j's slot of a read is
    ``q1 = nst + P`` and each kind chooses its slots: distinct, as a build
    gives them, so column j + 1's are distinct too. The stage view holds
    '$' at column len + 1 and A..T before it; ``cap`` is the pass's
    capacity (every slot of the pair below it, save "huge_c"); ``tile``
    gives the kernel's slot tile for (N, cap) (``pair_tile``, or
    ``pair_tile_rule`` on the CPU) and ``bucket`` its bucket's places
    (``pair_bucket``), which the kinds place their slots against: each
    fixes n and N first, then the tile of that capacity."""
    r = np.random.default_rng(seed)
    j, L = 4, 7
    T16 = 1 << 14

    def tile_of(n, N):  # the kernel's tile at this case's capacity
        return tile(N, -(-(n + 2 * N + 1) // 128) * 128)

    if kind == "tile_edges":
        n, N = 5 * T16, 516
        T = tile_of(n, N)
        edges = np.array([k * T + d for k in range(1, 5) for d in (-2, -1, 0, 1)])
        rest = r.choice(np.setdiff1d(np.arange(T // 2, n), edges), N - edges.size,
                        replace=False)
        q1 = np.concatenate([edges, rest])
    elif kind == "one_tile":  # a dense run: every tile it covers is full
        n, q1 = 4 * T16, np.arange(2 * T16, 3 * T16)
    elif kind == "empty_tiles":  # tiles 0 and 5 only
        n, N = 6 * T16 + 77, 600
        T = tile_of(n, N)
        q1 = np.concatenate([r.choice(np.arange(T // 2, T), 300, replace=False),
                             r.choice(np.arange(5 * T, 6 * T), 300, replace=False)])
    elif kind == "sparse":  # a warp a tile
        n = 200 * T16
        q1 = r.choice(np.arange(T16 // 2, n), 2000, replace=False)
    elif kind == "bucket_edges":  # tiles 1..6 hold bucket - 1 .. 2 bucket + 1 slots
        sizes = [bucket - 1, bucket, bucket + 1, 128, 129, 2 * bucket + 1]
        n, N = 64 * T16, sum(sizes) + 300
        T = tile_of(n, N)
        q1 = np.concatenate([r.choice(np.arange(k * T, (k + 1) * T), c, replace=False)
                             for k, c in enumerate(sizes, 1)]
                            + [r.choice(np.arange(8 * T, n), 300, replace=False)])
    elif kind == "clustered":  # runs of consecutive slots across tile edges
        runs = r.integers(40, 400, 24)
        n, N = 96 * T16, int(runs.sum())
        T = tile_of(n, N)
        edges = r.choice(np.arange(1, n // T), runs.size, replace=False) * T
        q1 = np.concatenate([e - r.integers(0, k) + np.arange(k) for e, k in zip(edges, runs)])
    elif kind == "many_big":  # 32 tiles past the warp's 128 slots at once
        sizes = r.integers(130, 300, 32)
        n, N = 1 << 21, int(sizes.sum())
        T = tile_of(n, N)
        tiles = r.choice(np.arange(1, n // T), sizes.size, replace=False)
        q1 = np.concatenate([r.choice(np.arange(t * T, (t + 1) * T), c, replace=False)
                             for t, c in zip(tiles, sizes)])
    elif kind == "one":
        n, q1 = 1000, np.array([777])
    elif kind == "past_2_30":  # the top 2^17 positions
        n = 2**30 + 2**17
        q1 = n - r.choice(2**17, N or 100_000, replace=False)
    else:  # no_second, ragged, huge_c
        N = N or {"no_second": 500, "ragged": 3000, "huge_c": 400}[kind]
        n = 13 * N
        q1 = r.choice(np.arange(N + 2, n), N, replace=False)
    N = q1.size
    nst = 2**30 + 12_345 if kind == "huge_c" else N + 2
    P = (q1 - nst if kind != "huge_c" else r.choice(n + 1, N, replace=False)).astype(np.int32)
    if kind == "no_second":
        lengths = np.full(N, j - 1)
    elif kind == "ragged":
        lengths = r.integers(j - 3, j + 3, N)
    else:
        lengths = np.full(N, L)
    cols = r.integers(1, 6, (L + 2, N)).astype(np.uint8)
    for c in range(L + 2):
        cols[c, lengths + 1 == c] = 0
        cols[c, lengths + 1 < c] = 0
    r.shuffle(P)
    cap = -(-(n + 2 * N + 1) // 128) * 128
    if kind == "huge_c":
        cap = -(-n // 128) * 128
    return dict(n=n, cap=cap, j=j, nst=int(nst), cols=cols, lengths=lengths.astype(np.int32),
                P=P, counts=np.array([0, n, 0, 0, 0, 0], np.int32),
                prev_v=np.ones(N, np.uint8))


def lf_pair_args(case, dev):
    """``lf_pair``'s arguments for a case, on ``dev``: the table is the
    packed table of the buffer padded to ``cap`` (through the merge pass
    with no inserts: the kernel on the card)."""
    t = lambda k: torch.from_numpy(case[k]).to(dev)  # noqa: E731
    old = torch.full((case["cap"],), 7, dtype=torch.uint8, device=dev)
    old[: case["n"]] = 1
    none = torch.zeros(0, dtype=torch.int32, device=dev)
    _, table, _ = merge_insert(old, none, none.to(torch.uint8), none.bool())
    return (case["j"], table, case["cap"], case["nst"], t("cols"), t("lengths"), t("P"),
            t("counts"), t("prev_v"))


# lf_group cases: the column groups of a CPU build at radix 2 of ragged
# reads, each captured with the state before its pass: the carry, the table
# and the buffer of B0, the order the stage loop hands over (None after a
# pair), and the build's sorted lengths (for the column-by-column oracle of
# tests/test_torch_group.py)
GROUP_SHAPES = {  # reads, gamma mean and sd (the benchmark's long-read shape, cut), seed
    "gamma": (300, 150, 130, 20), "thin_tail": (60, 4, 3, 21), "k3": (40, 30, 6, 22)}


def ragged_reads(n, mean, sd, seed):
    """n reads whose lengths are the quantiles of a gamma of ``mean`` and
    ``sd`` (``portbench.traffic.closed_loop_ragged.gamma_lengths``, the
    benchmark's long-read model), in an order and with symbols 1..5 drawn
    from ``seed``; the longest read made 4x longer for a thin tail."""
    from portbench.traffic.closed_loop_ragged import gamma_lengths

    r = np.random.default_rng(seed)
    lengths = r.permutation(gamma_lengths(n, mean, sd)).astype(np.int32)
    lengths[int(np.argmax(lengths))] *= 4
    reads = np.zeros((n, int(lengths.max())), np.uint8)
    for i, k in enumerate(lengths):
        reads[i, :k] = r.integers(1, 6, k)
    return reads, lengths


def group_captures(reads, lengths, monkeypatch, sorted_insert=True, keep=None, **kw):
    """The ``lf_group`` calls of a CPU build of these reads at radix 2
    (forced), in order; a call that ``keep(i, k)`` refuses (i its index, k
    its columns) is None. A kept call is a dict of its arguments (``order``
    None after a pair) and ``buf``, the buffer before its pass. Returns
    ``(calls, bwt)``."""
    from rust_msbwt_tpu_torch.ops import bcr, lf

    calls, state = [], {}

    def merge(old, q, v, active, **k):
        out = merge_insert_slots(old, q, v, active, **k)
        state["buf"] = out[0]
        return out

    def spy(j, tab, cap, nst, cols, lengths, by_len, acts, P, counts, prev_v, *, order=None):
        if keep is None or keep(len(calls), len(acts)):
            clone = lambda x: None if x is None else x.clone()  # noqa: E731
            buf = torch.full((cap,), rank.PAD, dtype=torch.uint8)  # PAD past the last pass's
            buf[: state["buf"].shape[0]] = state["buf"]
            calls.append(dict(j=j, tab=tab.clone(), cap=cap, nst=nst, cols=cols, lengths=lengths,
                              by_len=by_len, acts=np.array(acts), P=P.clone(),
                              counts=counts.clone(), prev_v=prev_v.clone(), order=clone(order),
                              buf=buf))
        else:
            calls.append(None)
        return lf.lf_group_plain(j, tab, cap, nst, cols, lengths, by_len, acts, P, counts, prev_v,
                                 order)

    monkeypatch.setenv("MSBWT_TPU_RADIX", "2")
    with monkeypatch.context() as m:
        m.setattr(bcr, "lf_group", spy)
        idx, _ = build_msbwt_with_index(reads, lengths, sorted_insert, device="cpu",
                                        merge=merge, **kw)
    return calls, idx.bwt[: idx.n]


def lf_group_args(call, dev):
    """``lf_group``'s positional arguments and its ``order`` for a captured
    call, on ``dev``."""
    to = lambda x: None if x is None else x.to(dev)  # noqa: E731
    return ((call["j"], to(call["tab"]), call["cap"], call["nst"], to(call["cols"]),
             to(call["lengths"]), to(call["by_len"]), call["acts"], to(call["P"]),
             to(call["counts"]), to(call["prev_v"])), to(call["order"]))


LF_WALK_KINDS = ["many", "aligned"]


def lf_walk_case(kind, seed):
    """A base BWT and a batch of new reads for the LF walks (also run on
    the CPU by tests/test_torch_lf.py against the JAX package):
    ``many``: 700 ragged base reads, 300 new; ``aligned``: 256 base reads
    of 3 bp, so n = 1024 and the cyclic search starts on the terminal row.
    Returns ``(base, n_strings, rot_max, reads, lengths)``, the new reads
    sorted, as host arrays."""
    from rust_msbwt_tpu_torch.ops.bcr import sort_reads

    r = np.random.default_rng(seed)
    if kind == "aligned":
        base_l = [r.integers(1, 6, 3).astype(np.uint8) for _ in range(256)]
        new_l = [r.integers(1, 6, r.integers(1, 6)).astype(np.uint8) for _ in range(77)]
    else:
        base_l = [r.integers(1, 6, r.integers(1, 41)).astype(np.uint8) for _ in range(700)]
        new_l = [r.integers(1, 6, r.integers(1, 41)).astype(np.uint8) for _ in range(300)]
    new_l += base_l[:5]  # ties with base terminators
    base = build_msbwt(*encode_reads(base_l), device="cpu")
    reads, lengths = sort_reads(*encode_reads(new_l))
    return base, len(base_l), max(len(x) for x in base_l) + 1, reads, lengths


def lf_walk_calls(case, dev):
    """The four walks of a case as ``{name: (wrapper, plain, args)}``, the
    arguments on ``dev``: the cyclic search of the new reads, the lengths
    of the base's strings, every base read extracted (l_max its longest
    read, and 2 less: some walks then do not close), every row located."""
    from rust_msbwt_tpu_torch.ops import bcr, lf

    base, n_strings, rot_max, reads, lengths = case
    idx, packed = index_from_symbols(torch.from_numpy(base).to(dev))
    tab, st, n = packed.table, packed.starts, packed.n
    steps, n_steps = bcr._cyclic_steps(lengths, rot_max, reads.shape[1])
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    cols = t(bcr.reads_to_cols(reads, lengths))
    ids = t(np.arange(n_strings, dtype=np.int32)[::-1])
    l_max = rot_max - 1
    return {
        "cyclic": (lf.lf_walk_cyclic, lf.lf_walk_cyclic_plain,
                   (tab, st, n, cols, t(lengths), t(steps), n_steps)),
        "lengths": (lf.lf_walk_lengths, lf.lf_walk_lengths_plain,
                    (idx.bwt, tab, st, n, n_strings)),
        "extract": (lf.lf_walk_extract, lf.lf_walk_extract_plain,
                    (idx.bwt, tab, st, ids, l_max)),
        "extract_short": (lf.lf_walk_extract, lf.lf_walk_extract_plain,
                          (idx.bwt, tab, st, ids, max(l_max - 2, 1))),
        "locate": (lf.lf_walk_locate, lf.lf_walk_locate_plain,
                   (idx.bwt, tab, st, t(np.arange(n, dtype=np.int32)), n_strings, l_max)),
    }


def _as_list(out):
    out = out if isinstance(out, tuple) else (out,)
    return [torch.as_tensor(o).cpu() for o in out]


@pytest.mark.parametrize("kind", LF_STAGE_KINDS + ["grid"])
def test_lf_stage_kernel_matches_plain(cuda, kind):
    """One column through the kernel and through ``lf_stage_plain`` on the
    same CUDA tensors: every output equal, one launch. ``grid``: N =
    1.1M, past the kernel's grid cap, so blocks take several strides."""
    from rust_msbwt_tpu_torch.ops.lf import lf_stage, lf_stage_plain

    case = (lf_stage_case("ragged", 99, N=1_100_003) if kind == "grid"
            else lf_stage_case(kind, len(kind)))
    args = lf_stage_args(case, cuda)
    before = lf_stage.launches
    got = lf_stage(*args)
    want = lf_stage_plain(*args)
    torch.cuda.synchronize()
    assert lf_stage.launches == before + 1
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert all(torch.equal(g, w) for g, w in zip(got, want))


@pytest.mark.parametrize("kind", LF_PAIR_KINDS + ["past_2_30", "grid"])
def test_lf_pair_kernel_matches_plain(cuda, kind):
    """One column pair through the kernels and through ``lf_pair_plain`` on
    the same CUDA tensors: every output equal, one call. The cases put
    slots on tile edges, fill every tile of a dense run (each past its
    bucket), leave tiles empty between two (the bitmap path), spread ~10 a
    tile (a warp a tile), fill tiles to bucket - 1, bucket, bucket + 1, 128
    and 129 slots, run slots across tile edges, put 130-300 slots in each
    of 32 tiles, take N = 1 and m2 = 0; ``past_2_30``: 100k slots past 2^30
    in a buffer of 2^30 + 2^17 symbols (8 16K tiles of ~12,500 slots: chunks
    up to the last, 65,544 tiles: the rank kernels' grid-stride loop); ``grid``: N =
    1.1M ragged reads, past the per-read kernels' grid cap."""
    from rust_msbwt_tpu_torch.ops.lf import lf_pair, lf_pair_plain

    case = (lf_pair_case("ragged", 99, N=1_100_003, tile=pair_tile(), bucket=pair_bucket())
            if kind == "grid"
            else lf_pair_case(kind, len(kind), tile=pair_tile(), bucket=pair_bucket()))
    args = lf_pair_args(case, cuda)
    before = lf_pair.launches
    got = lf_pair(*args)
    want = lf_pair_plain(*args)
    torch.cuda.synchronize()
    assert lf_pair.launches == before + 1
    assert [g.dtype for g in got] == [w.dtype for w in want]
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    if kind == "past_2_30":
        assert int(got[0].min()) > 2**30
    if kind == "no_second":
        assert not got[2][case["P"].size:].any()


def test_lf_pair_repeats_keep_counts(cuda):
    """lf_pair many times in a row on reused inputs, with one scratch for
    every call and lf_stage calls between (the stage loop's way): every
    output == the plain twin's each time; the scratch ends zeroed."""
    from rust_msbwt_tpu_torch.ops.lf import (lf_pair, lf_pair_plain, lf_stage, lf_stage_plain,
                                             stage_scratch)

    pairs = [lf_pair_args(lf_pair_case(kind, 7, tile=pair_tile(), bucket=pair_bucket()), cuda)
             for kind in ("ragged", "one", "no_second", "tile_edges", "one_tile",
                          "bucket_edges", "clustered")]
    stage = lf_stage_args(lf_stage_case("ragged", 7), cuda)
    want, want_stage = [lf_pair_plain(*a) for a in pairs], lf_stage_plain(*stage)
    scratch = stage_scratch(cuda)
    for k in range(24):
        got = lf_pair(*pairs[k % len(pairs)], scratch=scratch)
        assert all(torch.equal(g, w) for g, w in zip(got, want[k % len(pairs)])), k
        got = lf_stage(*stage, scratch=scratch)
        assert all(torch.equal(g, w) for g, w in zip(got, want_stage)), k
    torch.cuda.synchronize()
    assert not scratch.any()


def test_lf_pair_rejects_bad_input(cuda):
    """lf_pair refuses what its kernels do not take, before any launch."""
    from rust_msbwt_tpu_torch.ops.lf import lf_pair

    j, tab, cap, nst, cols, lengths, P, counts, prev_v = lf_pair_args(
        lf_pair_case("ragged", 5, tile=pair_tile(), bucket=pair_bucket()), cuda)
    before = lf_pair.launches
    with pytest.raises(TypeError):
        lf_pair(j, tab, cap, nst, cols, lengths, P.long(), counts, prev_v)
    with pytest.raises(ValueError):  # column j + 1 outside the stage view
        lf_pair(cols.shape[0] - 1, tab, cap, nst, cols, lengths, P, counts, prev_v)
    with pytest.raises(ValueError):  # a capacity past the table
        lf_pair(j, tab, 128 * tab.shape[0], nst, cols, lengths, P, counts, prev_v)
    with pytest.raises(ValueError):
        lf_pair(j, tab, cap, nst, cols, lengths, P.cpu(), counts, prev_v)
    with pytest.raises(TypeError):
        lf_pair(j, tab, cap, nst, cols, lengths, P, counts, prev_v,
                scratch=torch.zeros(8, dtype=torch.int64, device=cuda))
    assert lf_pair.launches == before


def test_lf_pair_tile_matches_rule(cuda):
    """The kernel library's slot tile and bucket are the ones the cases
    place their slots against (``pair_tile_rule``, ``PAIR_BUCKET``), over
    read counts and capacities from one read to 2^30 and the densities of a
    build's first columns to its last."""
    lib_tile = pair_tile()
    assert pair_bucket() == PAIR_BUCKET
    for N in (1, 7, 500, 516, 16_384, 500_000, 2_000_000, 1 << 30):
        for per in (1, 2, 3, 17, 100, 1_001, 4_000, 1 << 20):
            cap = min(N * per, 2**31 - 2)
            assert lib_tile(N, cap) == pair_tile_rule(N, cap), (N, cap)


@pytest.mark.parametrize("walk", ["cyclic", "lengths", "extract", "extract_short", "locate"])
@pytest.mark.parametrize("kind", LF_WALK_KINDS)
def test_lf_walk_kernel_matches_plain(cuda, kind, walk):
    """Each walk through the kernel and through its plain twin on the same
    CUDA tensors: equal, one launch (walker counts not multiples of the
    block)."""
    from rust_msbwt_tpu_torch.ops.lf import lf_walk_launches

    wrapper, plain, args = lf_walk_calls(lf_walk_case(kind, len(kind)), cuda)[walk]
    before = lf_walk_launches()
    got, want = _as_list(wrapper(*args)), _as_list(plain(*args))
    assert lf_walk_launches() == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


LF_WALK_EDGES = ["dollar", "one", "ragged", "big"]


def lf_walk_edge(edge, dev):
    """The walks at the edges of the walk kernels' lane groups (quads of a
    warp) and of the read-length walk's LF array, as ``lf_walk_calls``
    (card only: the plain twins' parity with the JAX package is
    tests/test_torch_lf.py's).
    ``dollar``: walkers that meet '$' at their first step beside ones that
    do not, in every warp: a base with empty strings (read lengths 0),
    extract from rows whose symbol is '$' and locate from rows below
    n_strings among the others, every third cyclic walker taking no step;
    ``one``: one walker of each walk; ``ragged``: the ``many`` case, whose
    extract walkers end at many different steps within each group of eight
    (asserted); ``big``: 1.1M walkers of each walk (1.1M strings of 0-3 bp
    built on the card, 1.1M new reads)."""
    from rust_msbwt_tpu_torch.ops.bcr import sort_reads

    if edge in ("dollar", "big"):
        r = np.random.default_rng(17 if edge == "dollar" else 18)
        n_base, n_new, top = (600, 200, 9) if edge == "dollar" else (1_100_000, 1_100_003, 4)
        lens = r.integers(0, top, n_base).astype(np.int32)
        if edge == "dollar":
            lens[::3] = 0
        reads = np.where(np.arange(top)[None, :] < lens[:, None],
                         r.integers(1, 6, (n_base, top)), 0).astype(np.uint8)
        base = build_msbwt(reads, lens, device=dev)
        new_l = r.integers(1, top, n_new).astype(np.int32)
        new = np.where(np.arange(top)[None, :] < new_l[:, None],
                       r.integers(1, 6, (n_new, top)), 0).astype(np.uint8)
        calls = lf_walk_calls((base, n_base, int(lens.max()) + 1, *sort_reads(new, new_l)), dev)
    else:
        calls = lf_walk_calls(lf_walk_case("many", 4), dev)
    if edge == "dollar":
        wrapper, plain, (tab, st, n, cols, lengths, steps, n_steps) = calls["cyclic"]
        steps = steps.clone()
        steps[::3] = 0
        calls["cyclic"] = (wrapper, plain, (tab, st, n, cols, lengths, steps, n_steps))
        wrapper, plain, (bwt, tab, st, ids, l_max) = calls["extract"]
        rows = torch.nonzero(bwt[: n] == 0).flatten().to(torch.int32)
        mixed = torch.stack([rows, ids[: rows.numel()]], 1).flatten()
        calls["extract"] = (wrapper, plain, (bwt, tab, st, mixed, l_max))
    if edge == "one":
        for walk, (wrapper, plain, args) in list(calls.items()):
            if walk == "cyclic":
                tab, st, n, cols, lengths, steps, n_steps = args
                args = (tab, st, n, cols[:, -1:].contiguous(), lengths[-1:], steps[-1:], n_steps)
            elif walk == "lengths":
                args = (*args[:4], 1)
            else:
                args = (*args[:3], args[3][-1:].clone(), *args[4:])
            calls[walk] = (wrapper, plain, args)
    if edge == "ragged":  # the first eight warps: every quad group of 8 lanes ragged
        _, plain, args = calls["extract"]
        steps = (plain(*args)[0] != 0).sum(1).cpu()
        assert all(len(set(g.tolist())) > 1 for g in steps[:64].view(-1, 8))
    return calls


@pytest.mark.parametrize("walk", ["cyclic", "lengths", "extract", "extract_short", "locate"])
@pytest.mark.parametrize("edge", LF_WALK_EDGES)
def test_lf_walk_edges_match_plain(cuda, edge, walk):
    """Each walk at the lane-group and LF-array edges (``lf_walk_edge``):
    kernel == plain twin on the same CUDA tensors, one launch."""
    from rust_msbwt_tpu_torch.ops.lf import lf_walk_launches

    wrapper, plain, args = lf_walk_edge(edge, cuda)[walk]
    before = lf_walk_launches()
    got, want = _as_list(wrapper(*args)), _as_list(plain(*args))
    assert lf_walk_launches() == before + 1
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_lf_stage_repeats_keep_counts(cuda):
    """lf_stage many times in a row on reused inputs, at grid sizes of one
    block, a few and the cap, with one scratch for every call (the stage
    loop's way): every output, counts_out above all (the kernel sums the
    counts in the scratch's accumulators, which its last block clears), ==
    the plain twin's each time, one launch a call; the scratch ends zeroed."""
    from rust_msbwt_tpu_torch.ops.lf import lf_stage, lf_stage_plain, stage_scratch

    cases = [lf_stage_args(lf_stage_case(kind, len(kind), N=N), cuda)
             for kind, N in (("ragged", None), ("one", None), ("ragged", 1_100_003),
                             ("inactive", None))]
    want = [lf_stage_plain(*args) for args in cases]
    scratch = stage_scratch(cuda)
    before = lf_stage.launches
    for k in range(40):
        got = lf_stage(*cases[k % len(cases)], scratch=scratch)
        assert all(torch.equal(g, w) for g, w in zip(got, want[k % len(cases)])), k
    torch.cuda.synchronize()
    assert lf_stage.launches == before + 40
    assert not scratch.any()


# Two lf_stage grids of ~100k reads (391 blocks of 256 threads each) fit on
# an H100 at once (132 SMs x 8 such blocks), so launches on two streams
# overlap on the card. The launches queue behind a spin of STREAM_GATE
# cycles (~1 s on an H100) on each stream: 512 wrapper calls that keep
# their outputs took 0.2-0.8 s to enqueue there, and launches that do not
# queue up run one at a time (the host is slower than the kernel).
STREAM_READS, STREAM_REPS, STREAM_GATE = 100_003, 256, 2_000_000_000


def _two_stream_launches(cuda, threaded, own_scratch, wrapper="lf_stage"):
    """``STREAM_REPS`` calls of ``wrapper`` (``lf_stage``, or ``lf_pair``:
    five device events a call) on each of two streams, each stream on its
    own inputs (two seeds), alternating with no sync between launches; each
    stream first runs a spin kernel, so the launches queue up behind it and
    the two queues drain on the card together. From one thread, or from
    two, each under its own ``torch.cuda.stream``. Returns each stream's
    inputs and outputs, and whether every launch was queued before the
    spins ended."""
    import threading

    from rust_msbwt_tpu_torch.ops import lf

    fn = getattr(lf, wrapper)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    if wrapper == "lf_pair":
        cases = [lf_pair_args(lf_pair_case("ragged", seed, N=STREAM_READS, tile=pair_tile(),
                                           bucket=pair_bucket()), cuda) for seed in (301, 302)]
    else:
        cases = [lf_stage_args(lf_stage_case("ragged", seed, N=STREAM_READS), cuda)
                 for seed in (301, 302)]
    torch.cuda.synchronize()
    outs, scratch = [[], []], [None, None]

    def launch(k):
        kw = {"scratch": scratch[k]} if own_scratch else {}
        outs[k].append(fn(*cases[k], **kw))

    fn(*cases[0])  # the library built and its kernels loaded before the spins
    torch.cuda.synchronize()
    for k, s in enumerate(streams):
        with torch.cuda.stream(s):
            scratch[k] = torch.zeros(8, dtype=torch.int32, device=cuda)  # lf_stage's, lf_pair's
            torch.cuda._sleep(STREAM_GATE)
    gate = torch.cuda.Event()
    gate.record(streams[1])
    if threaded:
        start = threading.Barrier(2)

        def run(k):
            with torch.cuda.stream(streams[k]):
                start.wait()
                for _ in range(STREAM_REPS):
                    launch(k)

        threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    else:
        for _ in range(STREAM_REPS):
            for k, s in enumerate(streams):
                with torch.cuda.stream(s):
                    launch(k)
    held = not gate.query()  # every launch queued while the spins ran
    torch.cuda.synchronize()
    return cases, outs, held


@pytest.mark.parametrize("own_scratch", [False, True], ids=["call_scratch", "stream_scratch"])
@pytest.mark.parametrize("threaded", [False, True], ids=["one_thread", "two_threads"])
def test_lf_stage_two_streams_match_plain(cuda, threaded, own_scratch):
    """lf_stage on two streams of one card at once (from one thread, or
    from two each under its own stream): every launch's outputs, counts_out
    above all, == lf_stage_plain on that stream's inputs. Overlapping grids
    must share no accumulator: with a scratch a call (the default) or one a
    stream (the stage loop's way). Failures are counted over all launches."""
    from rust_msbwt_tpu_torch.ops.lf import lf_stage_plain

    cases, outs, held = _two_stream_launches(cuda, threaded, own_scratch)
    bad = []
    for k, args in enumerate(cases):
        want = lf_stage_plain(*args)
        assert len(outs[k]) == STREAM_REPS
        for rep, got in enumerate(outs[k]):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                bad.append((k, rep, torch.equal(got[4], want[4])))
    assert not bad, (f"{len(bad)} of {2 * STREAM_REPS} launches differ from the twin "
                     f"({sum(not c for *_, c in bad)} in counts_out; all queued behind "
                     f"the spin: {held}); first {bad[:5]}")


@pytest.mark.parametrize("own_scratch", [False, True], ids=["call_scratch", "stream_scratch"])
@pytest.mark.parametrize("threaded", [False, True], ids=["one_thread", "two_threads"])
def test_lf_pair_two_streams_match_plain(cuda, threaded, own_scratch):
    """lf_pair on two streams of one card at once, as
    ``test_lf_stage_two_streams_match_plain``: every call's outputs, counts
    above all, == lf_pair_plain on that stream's inputs, with a scratch a
    call or one a stream. Failures are counted over all calls."""
    from rust_msbwt_tpu_torch.ops.lf import lf_pair_plain

    cases, outs, held = _two_stream_launches(cuda, threaded, own_scratch, "lf_pair")
    bad = []
    for k, args in enumerate(cases):
        want = lf_pair_plain(*args)
        assert len(outs[k]) == STREAM_REPS
        for rep, got in enumerate(outs[k]):
            if not all(torch.equal(g, w) for g, w in zip(got, want)):
                bad.append((k, rep, torch.equal(got[4], want[4])))
    assert not bad, (f"{len(bad)} of {2 * STREAM_REPS} calls differ from the twin "
                     f"({sum(not c for *_, c in bad)} in counts; all queued behind the "
                     f"spin: {held}); first {bad[:5]}")


def test_kernels_on_second_card_match_first(cuda):
    """With cuda:0 the current device, a build, a sorted extend (its two
    walks) and k-mer counts through both query tiers with every tensor on
    cuda:1: each kernel launched there, every output == the same run on
    cuda:0. Skips below two cards."""
    from rust_msbwt_tpu_torch.ops import lf, query
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed

    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA cards")
    base_reads, base_lens = _ragged(900, 81)
    reads, lengths = _ragged(700, 82)
    kmers = reads[lengths >= 8][:200, :8]  # the first 8 symbols of reads of 8 or more
    out = {}
    torch.cuda.set_device(0)
    for dev in ("cuda:0", "cuda:1"):
        before = (merge_mod.merge_insert.launches, lf.lf_stage.launches,
                  lf.lf_walk_launches(), query.kmer_ranges_packed.launches,
                  query.kmer_counts_pair.launches)
        base, _ = build_msbwt_with_index(base_reads, base_lens, device=dev)
        idx, packed = build_msbwt_with_index(reads, lengths, True, base.bwt[: base.n], 900,
                                             device=dev)
        packed_counts = count_kmers_packed(packed, kmers)
        pair_counts = count_kmers_pair(build_pair_index(idx), kmers)
        torch.cuda.synchronize(dev)
        after = (merge_mod.merge_insert.launches, lf.lf_stage.launches,
                 lf.lf_walk_launches(), query.kmer_ranges_packed.launches,
                 query.kmer_counts_pair.launches)
        assert all(a > b for a, b in zip(after, before)), (dev, before, after)
        assert torch.cuda.current_device() == 0
        assert idx.bwt.device == torch.device(dev)
        out[dev] = (idx.bwt.cpu(), packed.table.cpu(), np.asarray(packed_counts),
                    np.asarray(pair_counts))
    for a, b in zip(out["cuda:0"], out["cuda:1"]):
        assert np.array_equal(np.asarray(a), np.asarray(b))


def test_lf_walk_lengths_kernel_raises_on_open_walk(cuda):
    """A BWT without '$' on the walk: the device flag raises ValueError."""
    from rust_msbwt_tpu_torch.ops.lf import lf_walk_lengths

    idx, packed = index_from_symbols(torch.tensor([1, 1, 2, 2], dtype=torch.uint8,
                                                  device=cuda))
    with pytest.raises(ValueError, match="did not close"):
        lf_walk_lengths(idx.bwt, packed.table, packed.starts, packed.n, 1)


def test_lf_kernels_reject_bad_input(cuda):
    from rust_msbwt_tpu_torch.ops.lf import lf_stage

    j, tab, nst, cols, lengths, P, counts, prev_v = lf_stage_args(
        lf_stage_case("ragged", 5), cuda)
    with pytest.raises(TypeError):
        lf_stage(j, tab, nst, cols, lengths, P.long(), counts, prev_v)
    with pytest.raises(ValueError):
        lf_stage(j, tab, nst, cols, lengths[:-1], P, counts, prev_v)
    with pytest.raises(ValueError):
        lf_stage(j, tab, nst, cols, lengths, P.cpu(), counts, prev_v)
    with pytest.raises(ValueError):
        lf_stage(cols.shape[0], tab, nst, cols, lengths, P, counts, prev_v)
    args = (j, tab, nst, cols, lengths, P, counts, prev_v)
    for exc, scratch in ((TypeError, torch.zeros(8, dtype=torch.int64, device=cuda)),
                         (ValueError, torch.zeros(7, dtype=torch.int32, device=cuda)),
                         (ValueError, torch.zeros(8, dtype=torch.int32))):
        with pytest.raises(exc):
            lf_stage(*args, scratch=scratch)


@pytest.mark.parametrize("radix", [1, 2])
def test_build_counts_lf_stage_launches(cuda, monkeypatch, radix):
    """A build on the card takes one LF-step call a pass after stage 1: L
    lf_stage launches at radix 1; at radix 2 the schedule's (one lf_pair
    call a column pair, one lf_group call a column group of the ragged
    reads' tail, an lf_stage launch for a bucket's last column alone);
    none of the walks; its BWT and table equal the CPU's plain path."""
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.lf import lf_group, lf_pair, lf_stage, lf_walk_launches

    monkeypatch.setenv("MSBWT_TPU_RADIX", str(radix))
    reads, lengths = _ragged(1500, 71)
    N, L = lengths.size, reads.shape[1]
    steps = bcr.group_schedule(
        bcr.pair_buckets(bcr.bucket_schedule(0, N, L, int(lengths.sum()) + N, 128), L),
        bcr.active_counts(lengths, L), N)
    ks = [k for _, k, _ in steps] if radix == 2 else [1] * L
    before = (lf_stage.launches, lf_pair.launches, lf_group.launches, lf_group.columns)
    walks = lf_walk_launches()
    idx, packed = build_msbwt_with_index(reads, lengths, device=cuda)
    assert lf_stage.launches - before[0] == ks.count(1)
    assert lf_pair.launches - before[1] == ks.count(2)
    assert lf_group.launches - before[2] == sum(k > 2 for k in ks) > (radix - 2)
    assert lf_group.columns - before[3] == sum(k for k in ks if k > 2)
    assert lf_walk_launches() == walks
    idx_c, packed_c = build_msbwt_with_index(reads, lengths, device="cpu")
    assert torch.equal(idx.bwt.cpu(), idx_c.bwt) and torch.equal(packed.table.cpu(), packed_c.table)


@pytest.mark.parametrize("shape", list(GROUP_SHAPES))
def test_lf_group_kernel_matches_plain(cuda, monkeypatch, shape):
    """Every column group of a CPU build of ragged reads (gamma lengths at
    mean 150, the benchmark's long-read shape cut; a thin tail of 48
    columns; a group of three columns), through the kernels and through
    ``lf_group_plain`` on the same CUDA tensors: every output equal, one
    call and its columns counted each time, each call in the cluster form
    (``lf_group.cluster``), after a pair (the order sorted in the call) and
    after a group (the order handed on)."""
    from rust_msbwt_tpu_torch.ops.lf import lf_group, lf_group_cluster_max_n, lf_group_plain

    calls, _ = group_captures(*ragged_reads(*GROUP_SHAPES[shape]), monkeypatch)
    assert any(c["order"] is None for c in calls)
    assert shape != "k3" or min(len(c["acts"]) for c in calls) == 3
    assert lf_group_cluster_max_n(cuda) >= max(c["P"].numel() for c in calls)
    for c in calls:
        args, order = lf_group_args(c, cuda)
        before = (lf_group.launches, lf_group.columns, lf_group.cluster)
        got = lf_group(*args, order=order)
        want = lf_group_plain(*args, order)
        torch.cuda.synchronize()
        assert (lf_group.launches, lf_group.columns, lf_group.cluster) == (
            before[0] + 1, before[1] + len(c["acts"]), before[2] + 1)
        assert [g.dtype for g in got] == [w.dtype for w in want]
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def group_edge_lengths(N, short=2798):
    """N read lengths whose radix-2 schedule holds one column group that
    starts with all N reads active, ``short`` of which end there, then
    N - short of them, then 1,500 columns of two reads and one (with the
    default 2,798, I_t up to 2N - 98 of its 2N slots): ``short`` of 3 bp,
    the rest of 4 bp but two of 1,504 and 1,204 bp."""
    x = N - short - 2
    return np.array([3] * short + [4] * x + [1504, 1204], np.int32)


def checked_groups(cuda, reads, lengths, monkeypatch):
    """A one-shot build of these reads on the card whose every ``lf_group``
    call is also run through ``lf_group_plain`` on the same inputs and held
    equal to it, output by output. Returns the calls' ``acts``."""
    from rust_msbwt_tpu_torch.ops import bcr, lf

    seen = []

    def spy(*args, order=None):
        keep = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        kept_order = None if order is None else order.clone()
        got = lf.lf_group(*args, order=order)
        want = lf.lf_group_plain(*keep, kept_order)
        torch.cuda.synchronize()
        assert [g.dtype for g in got] == [w.dtype for w in want]
        assert all(torch.equal(g, w) for g, w in zip(got, want)), f"group at column {args[0]}"
        seen.append(np.array(args[7]))
        return got

    monkeypatch.setenv("MSBWT_TPU_RADIX", "2")
    with monkeypatch.context() as m:
        m.setattr(bcr, "lf_group", spy)
        build_msbwt_with_index(reads, lengths, device=cuda)
    return seen


@pytest.mark.parametrize("above,ends", [(0, 2798), (1, 2798), (0, 16_500)],
                         ids=["at_limit", "above_limit", "at_limit_ends"])
def test_lf_group_cluster_limit_matches_plain(cuda, monkeypatch, above, ends):
    """At the largest N the cluster form takes (``lf_group_cluster_max_n``)
    and one read above it, a build whose group starts with all N reads
    active and carries 1,500 columns of one or two reads
    (``group_edge_lengths``): every group == ``lf_group_plain``; at the
    limit each takes the cluster form, above it the cooperative one
    (``lf_group.cluster`` unmoved). With 2,798 reads ending in the group's
    first column, I_t comes within 98 of 2N; with all but 2,000 (at least
    16,500), a warp of the cluster form counts over 1,024 reads of '$' in
    that column's symbols."""
    from rust_msbwt_tpu_torch.ops.lf import lf_group, lf_group_cluster_max_n

    N = lf_group_cluster_max_n(cuda) + above
    short = ends if ends == 2798 else N - 2000
    assert N > 1 and short >= ends
    lengths = group_edge_lengths(N, short)
    reads = np.zeros((N, int(lengths.max())), np.uint8)
    r = np.random.default_rng(N)
    for i, k in enumerate(lengths):
        reads[i, :k] = r.integers(1, 6, k)
    before = lf_group.cluster
    acts = checked_groups(cuda, reads, lengths, monkeypatch)
    assert any(a[0] == N and a[1] == N - short and (a <= 2).sum() >= 1000
               and a.sum() >= N + (N - short) + 2700 for a in acts)
    assert lf_group.cluster - before == (0 if above else len(acts))


def test_lf_group_two_streams_match_plain(cuda, monkeypatch):
    """Two ragged builds at once (400 gamma-length reads each at mean
    1,500 bp), each from its own host thread under its own stream, both
    queued behind a spin so that their groups run on the card together:
    each == the same reads built alone at radix 1, BWT and table, every
    group in the cluster form (the counters, bumped from two threads
    without a lock, only checked to have moved)."""
    import threading

    from rust_msbwt_tpu_torch.ops.lf import lf_group, lf_group_cluster_max_n

    sets = [ragged_reads(400, 1500, 1300, seed) for seed in (24, 25)]
    monkeypatch.setenv("MSBWT_TPU_RADIX", "1")
    want = [build_msbwt_with_index(reads, lengths, device=cuda) for reads, lengths in sets]
    monkeypatch.setenv("MSBWT_TPU_RADIX", "2")
    build_msbwt_with_index(*sets[0], device=cuda)  # the library built, its limits found
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda) for _ in sets]
    for s in streams:
        with torch.cuda.stream(s):
            torch.cuda._sleep(STREAM_GATE)
    got, start = [None, None], threading.Barrier(2)
    before = (lf_group.launches, lf_group.cluster)

    def run(k):
        with torch.cuda.stream(streams[k]):
            start.wait()
            got[k] = build_msbwt_with_index(*sets[k], device=cuda)

    threads = [threading.Thread(target=run, args=(k,)) for k in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert lf_group_cluster_max_n(cuda) >= 400  # every group in the cluster form
    assert lf_group.launches > before[0] and lf_group.cluster > before[1]
    for (idx, packed), (idx1, packed1) in zip(got, want):
        assert torch.equal(idx.bwt, idx1.bwt) and torch.equal(packed.table, packed1.table)


def test_unforced_ragged_build_takes_groups(cuda, monkeypatch):
    """A one-shot build of 400 gamma-length long reads (mean 1,500 bp,
    radix 2 by the rule, unforced) runs its schedule's groups through
    ``lf_group`` (its calls and columns counted) and one merge pass a step,
    and equals the forced radix-1 build on the card, BWT and table."""
    from rust_msbwt_tpu_torch.ops import bcr
    from rust_msbwt_tpu_torch.ops.lf import lf_group

    reads, lengths = ragged_reads(400, 1500, 1300, 23)
    N, L = lengths.size, reads.shape[1]
    n_cap = int(lengths.sum()) + N
    monkeypatch.delenv("MSBWT_TPU_RADIX", raising=False)
    assert bcr.build_radix(n_cap, N) == 2
    steps = bcr.group_schedule(bcr.pair_buckets(bcr.bucket_schedule(0, N, L, n_cap, 128), L),
                               bcr.active_counts(lengths, L), N)
    groups = [k for _, k, _ in steps if k > 2]
    before = (merge_insert.launches, lf_group.launches, lf_group.columns)
    idx, packed = build_msbwt_with_index(reads, lengths, device=cuda)
    torch.cuda.synchronize(cuda)
    assert (merge_insert.launches - before[0], lf_group.launches - before[1],
            lf_group.columns - before[2]) == (1 + len(steps), len(groups), sum(groups))
    monkeypatch.setenv("MSBWT_TPU_RADIX", "1")
    idx1, packed1 = build_msbwt_with_index(reads, lengths, device=cuda)
    assert torch.equal(idx.bwt, idx1.bwt) and torch.equal(packed.table, packed1.table)


def test_unforced_append_takes_radix2(cuda, monkeypatch):
    """A 2k x 100 bp append onto a 200k x 100 bp base (10,201 buffer
    symbols a new read) takes radix 2 by itself: stage 1's pass and 50
    column pairs, so 51 merge passes, 50 ``lf_pair`` calls and no
    ``lf_stage``; its BWT and table equal the forced radix-1 append's (100
    ``lf_stage`` launches, 101 passes)."""
    from rust_msbwt_tpu_torch.ops.lf import lf_pair, lf_stage

    r = np.random.default_rng(18)
    base_reads = r.integers(1, 6, (200_000, 100)).astype(np.uint8)
    reads = r.integers(1, 6, (2_000, 100)).astype(np.uint8)
    lengths = np.full(2_000, 100, np.int32)
    monkeypatch.delenv("MSBWT_TPU_RADIX", raising=False)
    base, base_packed = build_msbwt_with_index(base_reads, np.full(200_000, 100, np.int32),
                                               device=cuda)
    out = {}
    for radix in (None, "1"):
        if radix:
            monkeypatch.setenv("MSBWT_TPU_RADIX", radix)
        before = (merge_insert.launches, lf_pair.launches, lf_stage.launches)
        idx, packed = build_msbwt_with_index(reads, lengths, True, base.bwt[: base.n],
                                             200_000, 101, device=cuda,
                                             base_index=base_packed)
        torch.cuda.synchronize(cuda)
        out[radix] = (idx.bwt, packed.table, merge_insert.launches - before[0],
                      lf_pair.launches - before[1], lf_stage.launches - before[2])
    assert out[None][2:] == (51, 50, 0)
    assert out["1"][2:] == (101, 0, 100)
    assert torch.equal(out[None][0], out["1"][0]) and torch.equal(out[None][1], out["1"][1])


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_extend_through_lf_kernels_matches_cpu(cuda, sorted_insert):
    """An extend on the card (its read-length and cyclic walks and stage
    columns through the kernels) and a streamed build == the CPU's."""
    from rust_msbwt_tpu_torch.ops import lf

    base_reads, base_lens = _ragged(900, 73)
    reads, lengths = _ragged(700, 74)
    base = build_msbwt(base_reads, base_lens, device="cpu")
    before = (lf.lf_stage.launches, lf.lf_walk_lengths.launches, lf.lf_walk_cyclic.launches)
    got = build_msbwt(reads, lengths, sorted_insert, base, 900, device=cuda)
    after = (lf.lf_stage.launches, lf.lf_walk_lengths.launches, lf.lf_walk_cyclic.launches)
    assert after[0] - before[0] == reads.shape[1]
    assert [a - b for a, b in zip(after[1:], before[1:])] == ([1, 1] if sorted_insert else [0, 0])
    assert np.array_equal(got, build_msbwt(reads, lengths, sorted_insert, base, 900,
                                           device="cpu"))
    b = StreamingBuilder(device=cuda)
    for i in range(0, 700, 300):
        b.add_batch(reads[i: i + 300], lengths[i: i + 300])
    assert np.array_equal(b.finish(), build_msbwt(reads, lengths, device="cpu"))


def test_extract_locate_through_lf_kernels_match_cpu(cuda):
    from rust_msbwt_tpu_torch.ops import lf
    from rust_msbwt_tpu_torch.ops.extract import extract_reads, locate_kmers

    reads, lengths = _ragged(800, 75)
    kmers = reads[:50, :4]
    out = []
    for dev in (cuda, "cpu"):
        idx, packed = build_msbwt_with_index(reads, lengths, device=dev)
        before = (lf.lf_walk_extract.launches, lf.lf_walk_locate.launches)
        got = extract_reads(idx, np.arange(800), 800, packed=packed)
        hits = locate_kmers(idx, kmers, 800, lengths=np.minimum(lengths[:50], 4),
                            packed=packed)
        launched = (lf.lf_walk_extract.launches - before[0],
                    lf.lf_walk_locate.launches - before[1])
        assert launched == ((1, 1) if dev == cuda else (0, 0))
        out.append((got, hits))
    (g_k, h_k), (g_c, h_c) = out
    assert all(np.array_equal(a, b) for a, b in zip(g_k, g_c))
    assert all(np.array_equal(a, b) for a, b in zip(h_k, h_c))


# --- the query kernels (ops/query.py, csrc/query.cu) ------------------------

QUERY_KINDS = ["one", "empty", "absent", "aligned", "ragged", "mixed"]
# (kind, cache depth) of the card cases: the kinds, then cached batches and
# a batch of 1.1M queries
QUERY_CASES = [(k, 0) for k in QUERY_KINDS] + [("ragged", 8), ("ragged", 9), ("ragged", 11),
                                               ("mixed", 8), ("mixed", 9), ("mixed", 11),
                                               ("grid", 8)]
# Batch sizes at the edges of the kernels' lane groups (eight lanes a group;
# a group holds two packed queries or one pair query, so a warp holds 8 or
# 4 and a 256-lane block 64 or 32): one query, part of a group, part of a
# warp, a warp and one more, a block and one more, and a batch that is a
# multiple of neither. Each is a ``ragged`` batch, with no cache and 6^9.
QUERY_SIZES = [1, 2, 3, 5, 7, 9, 33, 65, 1000]
QUERY_SIZE_CASES = [(B, ck) for B in QUERY_SIZES for ck in (0, 9)]


@functools.lru_cache(maxsize=4)
def _query_bwt(n_reads, read_len, seed):
    """A BWT of ``n_reads`` x ``read_len`` reads from a random 2,000-base
    genome (built on the CPU), and the reads."""
    r = np.random.default_rng(seed)
    genome = r.integers(1, 6, 2000).astype(np.uint8)
    st = r.integers(0, genome.size - read_len + 1, n_reads)
    reads = genome[st[:, None] + np.arange(read_len)[None, :]]
    return build_msbwt(reads, np.full(n_reads, read_len, np.int32), device="cpu"), reads


def query_case(kind, cache_k=0, B=None):
    """One query batch from a seed (also run on the CPU by
    tests/test_torch_query.py against the JAX package, and on the card by
    chip_smoke.py): a BWT and B right-aligned 21-mers with their lengths.
    ``one``: B = 1; ``empty``: B = 0; ``absent``: random 21-mers, none in
    the reads, so every range empties after a few steps; ``aligned``: n =
    25,600 (256 reads of 99 bp, n % 128 == 0), so every query's first step
    ranks at hi == n, and lengths 0..21; ``ragged``: n = 25,755 (255 x 100
    bp), lengths 0..21, a tenth of the queries random; ``grid``: ``ragged``
    at B = 1,100,003; ``mixed``: the ``ragged`` index, B = 64, each four
    queries in a row (one pair-tier group of a warp's four, half a
    packed-tier warp) a random one that stops early, a full one (K), one of
    the other parity (K - 1: the pair tier's last round is a one-symbol
    tail or not) and one of cache_k + 1 symbols (one step: a tail). With
    ``cache_k`` every length is at least cache_k."""
    K = 21
    dec, reads = _query_bwt(256, 99, 1) if kind == "aligned" else _query_bwt(255, 100, 2)
    r = np.random.default_rng(len(kind) + 100 * cache_k)
    if B is None:
        B = {"one": 1, "empty": 0, "grid": 1_100_003, "mixed": 64}.get(kind, 3000)
    rows, offs = r.integers(0, reads.shape[0], B), r.integers(0, reads.shape[1] - K + 1, B)
    kmers = reads[rows[:, None], offs[:, None] + np.arange(K)[None, :]]
    lengths = r.integers(cache_k, K + 1, B).astype(np.int32)
    if kind == "mixed":
        role = np.arange(B) % 4
        kmers[role == 0] = r.integers(1, 6, (int((role == 0).sum()), K))
        lengths = np.array([K, K, K - 1, cache_k + 1], np.int32)[role]
    else:
        n_random = B if kind == "absent" else B // 10
        kmers[B - n_random:] = r.integers(1, 6, (n_random, K))
    if kind in ("one", "absent"):
        lengths[:] = K
    kmers[np.arange(K)[None, :] < (K - lengths)[:, None]] = 0
    return dict(dec=dec, kmers=kmers, lengths=lengths, cache_k=cache_k)


def query_calls(case, dev, cache=None):
    """Both query kernels' calls on a case as ``{tier: (wrapper, plain,
    args)}``, the arguments on ``dev``. The prefix cache of the case's
    depth is ``cache``, or built on ``dev`` through the occurrence index."""
    from rust_msbwt_tpu_torch.ops import packed_rank, pair_rank, query

    idx, packed = index_from_symbols(torch.from_numpy(case["dec"]).to(dev))
    pair = build_pair_index(idx)
    ck = case["cache_k"]
    if ck and cache is None:
        cache = rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, ck)
    km = torch.from_numpy(case["kmers"]).to(dev)
    ln = torch.from_numpy(case["lengths"]).to(dev)
    return {"packed": (query.kmer_ranges_packed, packed_rank.kmer_ranges_packed_plain,
                       (packed.table, packed.starts, packed.n, km, ln, cache, ck)),
            "pair": (query.kmer_counts_pair, pair_rank.kmer_counts_pair_plain,
                     (pair.table2, pair.starts, pair.dmat, pair.n, km, ln, cache, ck))}


@pytest.mark.parametrize("kind,cache_k", QUERY_CASES)
def test_query_kernels_match_plain(cuda, kind, cache_k):
    """Each tier's batch through its kernel and through its plain twin on
    the same CUDA tensors: equal (lo and hi for the packed tier, the
    counts for the pair tier), one launch (none for B = 0)."""
    _check_query_kernels(cuda, kind, query_case(kind, cache_k))


@pytest.mark.parametrize("B,cache_k", QUERY_SIZE_CASES)
def test_query_group_edges_match_plain(cuda, B, cache_k):
    """Batches of every size at the edges of the kernels' lane groups,
    warps and blocks (``QUERY_SIZES``): kernel == plain twin, one launch;
    through the C entry points into outputs 128 entries longer than the
    batch, the batch's B entries equal and nothing written past them."""
    from rust_msbwt_tpu_torch.ops.lf import _launch
    from rust_msbwt_tpu_torch.ops.query import _batch

    case = query_case("ragged", cache_k, B=B)
    _check_query_kernels(cuda, "ragged", case)
    for tier, (_, plain, args) in query_calls(case, cuda).items():
        pair = tier == "pair"
        table, starts = args[:2]
        n, kmers, lengths, cache, ck = args[3:] if pair else args[2:]
        dev = table.device
        clo, chi, ck = _batch(dev, starts, n, kmers, lengths, cache, ck)
        out = torch.full((1 if pair else 2, B + 128), -7, dtype=torch.int32, device=dev)
        if pair:
            _launch("msbwt_kmer_counts_pair", table, starts, args[2], kmers, lengths, clo, chi,
                    out[0], B, table.shape[0], kmers.shape[1], ck, n, dev=dev)
        else:
            _launch("msbwt_kmer_ranges_packed", table, starts, kmers, lengths, clo, chi, out[0],
                    out[1], B, kmers.shape[1], ck, n, dev=dev)
        assert torch.equal(out[:, :B].cpu(), torch.stack(_as_list(plain(*args)))), tier
        assert bool((out[:, B:] == -7).all()), tier


def _check_query_kernels(cuda, kind, case):
    B = case["kmers"].shape[0]
    for tier, (wrapper, plain, args) in query_calls(case, cuda).items():
        before = wrapper.launches
        got, want = _as_list(wrapper(*args)), _as_list(plain(*args))
        assert wrapper.launches == before + (1 if B else 0), tier
        assert [g.dtype for g in got] == [w.dtype for w in want] == [torch.int32] * len(got)
        assert all(g.shape == (B,) and torch.equal(g, w) for g, w in zip(got, want)), tier
        if kind == "absent":
            assert not bool((got[-1] - got[0] if tier == "packed" else got[0]).any())


@pytest.mark.parametrize("tier", ["packed", "pair"])
def test_count_batch_splits_short_queries(cuda, tier):
    """``count_batch`` with a 6^8 cache and lengths 0..21: the queries
    shorter than 8 are one more launch; the counts equal the CPU's."""
    from rust_msbwt_tpu_torch.ops import query
    from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed

    case = query_case("ragged")
    kmers, lengths = case["kmers"], case["lengths"]
    assert (lengths < 8).any() and (lengths >= 8).any()
    counts = []
    for dev in (cuda, "cpu"):
        idx, packed = index_from_symbols(torch.from_numpy(case["dec"]).to(dev))
        cache = rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 8)
        wrapper = query.kmer_ranges_packed if tier == "packed" else query.kmer_counts_pair
        before = wrapper.launches
        counts.append(count_kmers_packed(packed, kmers, lengths, cache=cache, cache_k=8)
                      if tier == "packed" else
                      count_kmers_pair(build_pair_index(idx), kmers, lengths, cache=cache,
                                       cache_k=8))
        assert wrapper.launches - before == (2 if dev == cuda else 0)
    assert np.array_equal(counts[0], counts[1])


def test_query_kernels_reject_bad_input(cuda):
    """Wrong dtypes, a table off a 16-byte boundary, a tensor on another
    device and a cache of the wrong depth are refused before any launch."""
    calls = query_calls(query_case("ragged", B=100), cuda)
    for tier, (wrapper, _, args) in calls.items():
        args = list(args)
        k = 3 if tier == "packed" else 4  # kmers; lengths follow
        tab = args[0]
        flat = torch.empty(tab.numel() + 4, dtype=torch.int32, device=cuda)
        misaligned = flat[1: 1 + tab.numel()].view(tab.shape)
        misaligned.copy_(tab)
        bad = [(TypeError, {k: args[k].long()}), (TypeError, {k + 1: args[k + 1].long()}),
               (ValueError, {0: misaligned}), (ValueError, {k + 1: args[k + 1].cpu()}),
               (ValueError, {k: args[k][:, 1:].contiguous()[:50]}),
               (ValueError, {k + 2: rank.KmerCache(args[0][:6, 0].clone(),
                                                   args[0][:6, 0].clone()),
                             k + 3: 2})]
        before = wrapper.launches
        for exc, change in bad:
            with pytest.raises(exc):
                wrapper(*[change.get(i, a) for i, a in enumerate(args)])
        assert wrapper.launches == before
