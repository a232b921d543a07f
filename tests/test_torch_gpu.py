"""Card tests of the port: the merge-insert CUDA kernel against its plain
PyTorch twin on the same CUDA tensors — one pass, a build, an extend build
onto a non-empty base, and a streamed build — the query tiers (pair index,
run tier, a chunked deep prefix cache, ``RleBWT``'s policy), the H-M and
doubling merges and two gloo ranks sharing the card, each against the same
functions on the CPU. Bit-exact throughout (tolerance 0: every output is an
integer).

Marked ``gpu``; without a card every test skips (the decision is made in a
fixture, never at import time). This file imports no jax, so it runs on a
machine with only torch:

    python -m pytest --noconftest -o addopts="" -m gpu tests/test_torch_gpu.py
"""

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
