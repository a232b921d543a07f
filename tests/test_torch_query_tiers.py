"""The port's query side against the JAX package, on CPU: the pair index,
deep prefix caches, the run-compressed tier, ``RleBWT`` / ``DynamicBWT``'s
tier policy, query-index packs and the parity FM tables.

The same seeded inputs (numpy) go through both packages; every comparison
is bit-exact (tolerance 0: every output is an integer). One BWT of a few
thousand symbols, built from seeded reads, serves most tests, so the JAX
side compiles few programs.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.models.dynamic import DynamicBWT as JDynamicBWT
from rust_msbwt_tpu.models.rle_bwt import RleBWT as JRleBWT
from rust_msbwt_tpu.ops import pair_rank as jpair
from rust_msbwt_tpu.ops import rank as jrank
from rust_msbwt_tpu.ops import run_rank as jrun
from rust_msbwt_tpu.ops.packed_rank import pack_index as j_pack_index
from rust_msbwt_tpu.utils import checkpoint as jckpt

from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT, build_sampled_fm_index
from rust_msbwt_tpu_torch.models.core import BWTRange
from rust_msbwt_tpu_torch.ops import pair_rank, rank, run_rank
from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN, convert_stoi
from rust_msbwt_tpu_torch.ops.bcr import build_msbwt, index_from_symbols
from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
from rust_msbwt_tpu_torch.ops.rle import bytes_from_runs, convert_to_vec, runs_from_symbols
from rust_msbwt_tpu_torch.utils import checkpoint
from rust_msbwt_tpu_torch.utils.convert import (
    kmer_cache_from_numpy,
    occ_index_from_numpy,
    pair_index_from_numpy,
    run_index_from_numpy,
)

from tests.test_rle_bwt import _PINNED
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

K_MAX = 21  # one k-mer matrix width for the whole file (JAX compiles per shape)


def _reads_bwt(n_reads, read_len, genome_len, seed):
    """A real BWT: ``n_reads`` reads of ``read_len`` from a random genome."""
    r = np.random.default_rng(seed)
    genome = r.integers(1, 6, genome_len).astype(np.uint8)
    starts = r.integers(0, genome_len - read_len + 1, n_reads)
    reads = genome[starts[:, None] + np.arange(read_len)[None, :]]
    lengths = np.full(n_reads, read_len, np.int32)
    return build_msbwt(reads, lengths, device="cpu"), reads


@pytest.fixture(scope="module")
def corpus():
    """98 reads x 50 bp from a 400-base genome (n = 4998), right-aligned
    queries of lengths 1..21 drawn from the reads, plus random ones."""
    dec, reads = _reads_bwt(98, 50, 400, 0xA11)
    r = np.random.default_rng(7)
    B = 256
    rows = r.integers(0, reads.shape[0], B)
    offs = r.integers(0, 50 - K_MAX + 1, B)
    kmers = reads[rows[:, None], offs[:, None] + np.arange(K_MAX)[None, :]]
    kmers[-40:] = r.integers(0, 6, (40, K_MAX))
    lengths = r.integers(1, K_MAX + 1, B).astype(np.int32)
    lengths[:100] = K_MAX
    kmers[np.arange(K_MAX)[None, :] < (K_MAX - lengths)[:, None]] = 0
    jidx = jrank.build_occ_index(dec)
    want = jrank.count_kmers(jidx, kmers, lengths)
    return dec, jidx, kmers, lengths, want


def _port_occ(jidx):
    return occ_index_from_numpy(np.asarray(jidx.bwt), np.asarray(jidx.occ),
                                np.asarray(jidx.starts), jidx.n, "cpu")


# --- the pair index ---


@pytest.mark.parametrize("n", [1, 127, 128, 300, 1000, 4096])
def test_pair_index_matches_jax(n):
    dec = np.random.default_rng(n).integers(0, 6, n).astype(np.uint8)
    jidx = jrank.build_occ_index(dec)
    idx = _port_occ(jidx)
    ps = pair_rank._build_pair_stream_flat(idx.bwt, idx.occ, idx.starts, n=n)
    jps = jpair._build_pair_stream_flat(jidx.bwt, jidx.occ, jidx.starts, n=n)
    assert np.array_equal(ps.numpy(), np.asarray(jps))
    jp = jpair.build_pair_index(jidx)
    p = pair_rank.build_pair_index(idx)
    assert p.table2.shape == (max(1, -(-n // 128)), 60)
    assert np.array_equal(p.table2.numpy(), np.asarray(jp.table2))
    assert np.array_equal(p.dmat.numpy(), np.asarray(jp.dmat))
    assert np.array_equal(pair_rank._build_pair_table(ps).numpy(), np.asarray(jp.table2))


@pytest.mark.parametrize("chunk_bins", [1, 3])
def test_pair_index_chunked_build(monkeypatch, chunk_bins):
    dec = np.random.default_rng(11).integers(0, 6, 1000).astype(np.uint8)
    idx = rank.build_occ_index(dec, device="cpu")
    whole = pair_rank.build_pair_index(idx)
    monkeypatch.setattr(pair_rank, "_PAIR_CHUNK_BINS", chunk_bins)
    chunked = pair_rank.build_pair_index(idx)
    assert torch.equal(chunked.table2, whole.table2)
    assert torch.equal(chunked.dmat, whole.dmat)


@pytest.mark.parametrize("cached", [False, True])
@pytest.mark.parametrize("K", [1, 2, 3, 6, 11, 21])
def test_count_kmers_pair_matches_jax(corpus, K, cached):
    dec, jidx, kmers, lengths, _ = corpus
    km = kmers[:, K_MAX - K:]
    ln = np.minimum(lengths, K)
    jp = jpair.build_pair_index(jidx)
    p = pair_rank.build_pair_index(_port_occ(jidx))
    cache_k = min(K, 3) if cached else 0
    cache = jcache = None
    if cached:
        jcache = jrank.build_kmer_cache(jidx.bwt, jidx.occ, jidx.starts, jidx.n, cache_k)
        cache = kmer_cache_from_numpy(np.asarray(jcache.lo), np.asarray(jcache.hi), "cpu")
    got = pair_rank.count_kmers_pair(p, km, ln, cache=cache, cache_k=cache_k)
    want = jpair.count_kmers_pair(jp, km, ln, cache=jcache, cache_k=cache_k)
    assert got.dtype == np.int64
    assert np.array_equal(got, np.asarray(want))
    assert np.array_equal(got, jrank.count_kmers(jidx, km, ln))
    carried = pair_index_from_numpy(np.asarray(jp.table2), np.asarray(jp.starts),
                                    np.asarray(jp.dmat), jp.n, "cpu")
    assert np.array_equal(pair_rank.count_kmers_pair(carried, km, ln, cache=cache,
                                                     cache_k=cache_k), got)


@pytest.mark.parametrize("n_reads", [8, 16])
def test_pair_counts_at_n_multiple_of_128(n_reads):
    """n = 128 and n = 256 (8 and 16 reads of 15 bp): the pair tier equals
    the packed tier and a host loop. The JAX package's pair reader gathers
    row n / 128 of its table for the bound ``hi = n``, a row that does not
    exist; ``jnp.take`` fills it and most counts come out wrong (even
    negative). The port reads the last row with a full-bin mask instead, so
    it is not compared with JAX here."""
    r = np.random.default_rng(n_reads)
    reads = r.integers(1, 6, (n_reads, 15)).astype(np.uint8)
    dec = build_msbwt(reads, np.full(n_reads, 15, np.int32), device="cpu")
    assert dec.size == 128 * (n_reads // 8)
    idx, packed = index_from_symbols(torch.from_numpy(dec))
    p = pair_rank.build_pair_index(idx)
    kmers = np.vstack([reads[:, :3], reads[:, 5:8], r.integers(0, 6, (40, 3))]).astype(np.uint8)
    lengths = r.integers(1, 4, kmers.shape[0]).astype(np.int32)
    kmers[np.arange(3)[None, :] < (3 - lengths)[:, None]] = 0
    got = pair_rank.count_kmers_pair(p, kmers, lengths)
    assert np.array_equal(got, count_kmers_packed(packed, kmers, lengths))
    host = RleBWT(device="cpu")
    host.load_vector(bytes_from_runs(*runs_from_symbols(dec)))
    loop = [host.count_kmer(kmers[i, 3 - lengths[i]:]) for i in range(kmers.shape[0])]
    assert got.tolist() == loop


def test_pair_reader_rejects_legacy_rows():
    table2 = torch.zeros((2, 128), dtype=torch.int32)
    with pytest.raises(ValueError):
        pair_rank._count_kmers_pair_impl(table2, torch.zeros(7, dtype=torch.int32),
                                         torch.zeros(36, dtype=torch.int32), 100,
                                         torch.ones((1, 2), dtype=torch.uint8),
                                         torch.full((1,), 2, dtype=torch.int32))


# --- deep prefix caches ---


@pytest.fixture(scope="module")
def deep_caches(corpus):
    """The 6^8 and 6^9 caches of the corpus, built once (the 6^9 one in
    chunks of 6^6 ranges, which keeps the CPU build's memory small)."""
    dec, jidx, *_ = corpus
    idx = _port_occ(jidx)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rank, "_CACHE_LEVEL_CHUNK", 6**6)
        caches = {k: rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, k)
                  for k in (8, 9)}
    return caches


def test_deep_cache_k9_matches_jax(corpus, deep_caches):
    _, jidx, *_ = corpus
    jc = jrank.build_kmer_cache(jidx.bwt, jidx.occ, jidx.starts, jidx.n, 9)
    assert np.array_equal(deep_caches[9].lo.numpy(), np.asarray(jc.lo))
    assert np.array_equal(deep_caches[9].hi.numpy(), np.asarray(jc.hi))


@pytest.mark.parametrize("chunk", [6**3 + 5, 1000, 1])
def test_deep_cache_chunking(monkeypatch, chunk):
    """A patched chunk size (non-dividing ones included) gives the same
    cache as the unchunked build."""
    dec = np.random.default_rng(3).integers(0, 6, 700).astype(np.uint8)
    idx = rank.build_occ_index(dec, device="cpu")
    k = 7 if chunk > 1 else 4
    whole = rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, k)
    monkeypatch.setattr(rank, "_CACHE_LEVEL_CHUNK", chunk)
    part = rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, k)
    assert torch.equal(part.lo, whole.lo) and torch.equal(part.hi, whole.hi)


@pytest.mark.parametrize("cache_k", [0, 8, 9])
@pytest.mark.parametrize("tier", ["packed", "pair", "run"])
def test_every_tier_counts_with_deep_caches(corpus, deep_caches, tier, cache_k):
    dec, jidx, kmers, lengths, want = corpus
    idx, packed = index_from_symbols(torch.from_numpy(dec))
    cache = deep_caches.get(cache_k)
    if tier == "packed":
        got = count_kmers_packed(packed, kmers, lengths, cache=cache, cache_k=cache_k)
    elif tier == "pair":
        got = pair_rank.count_kmers_pair(pair_rank.build_pair_index(idx), kmers, lengths,
                                         cache=cache, cache_k=cache_k)
    else:
        ridx = run_rank.build_run_index(*runs_from_symbols(dec), device="cpu")
        got = run_rank.count_kmers_runs(ridx, kmers, lengths, cache=cache, cache_k=cache_k)
    assert np.array_equal(got, want)


def test_cache_depth_checks():
    idx = rank.build_occ_index(np.array([5, 1, 0], np.uint8), device="cpu")
    with pytest.raises(ValueError):
        rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 0)
    ridx = run_rank.build_run_index(np.array([5, 1, 0], np.uint8), np.ones(3), device="cpu")
    with pytest.raises(ValueError):
        run_rank.build_kmer_cache_runs(ridx, 9)


# --- the run tier ---


def _long_runs():
    r = np.random.default_rng(41)
    return np.concatenate([np.full(r.integers(1, 3 * run_rank.MAX_RUN), r.integers(0, 6),
                                   np.uint8) for _ in range(30)])


def _straddle():
    # runs of length 1: every row covers exactly RB positions, so seek
    # windows straddle row boundaries at every offset
    d = np.random.default_rng(23).integers(0, 6, 5 * run_rank.RB + 17).astype(np.uint8)
    return np.where(np.arange(d.size) % 2 == 0, d % 3, 3 + d % 3).astype(np.uint8)


RUN_CASES = {
    "reads": lambda: _reads_bwt(12, 30, 200, 3)[0],
    "long_runs": _long_runs,
    "straddle": _straddle,
    "empty": lambda: np.zeros(0, np.uint8),
    "one_run": lambda: np.full(5, 2, np.uint8),
    "exact_row": lambda: np.arange(run_rank.RB, dtype=np.uint8) % 6,
}


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_run_index_matches_jax(case):
    dec = RUN_CASES[case]()
    syms, lens = runs_from_symbols(dec)
    ridx = run_rank.build_run_index(syms, lens, device="cpu")
    jr = jrun.build_run_index(syms, lens.astype(np.int64))
    assert ridx.n == jr.n == dec.size
    assert np.array_equal(ridx.table.numpy(), np.asarray(jr.table))
    assert np.array_equal(ridx.seek.numpy(), np.asarray(jr.seek))
    assert np.array_equal(ridx.starts.numpy(), np.asarray(jr.starts))
    assert ridx.device_bytes() == jr.device_bytes()
    from_bytes = run_rank.build_run_index_from_bytes(bytes_from_runs(syms, lens), device="cpu")
    assert torch.equal(from_bytes.table, ridx.table)


@pytest.mark.parametrize("case", list(RUN_CASES))
def test_rank_runs_exhaustive(case):
    """Every position (n included) and every symbol, against the port's
    occurrence-index rank and the JAX package's run-tier rank."""
    dec = RUN_CASES[case]()
    n = dec.size
    ridx = run_rank.build_run_index(*runs_from_symbols(dec), device="cpu")
    idx = rank.build_occ_index(dec, device="cpu")
    pos = np.arange(0, n + 1, max(1, n // 3000), dtype=np.int32)
    pos = np.concatenate([pos, [n]]).astype(np.int32)
    sym = np.repeat(np.arange(VC_LEN, dtype=np.int32), pos.size)
    pos = np.tile(pos, VC_LEN)
    got = run_rank.rank_runs(ridx.table, ridx.seek, torch.from_numpy(sym), torch.from_numpy(pos))
    assert torch.equal(got, rank.rank(idx, torch.from_numpy(sym), torch.from_numpy(pos)))
    jr = jrun.build_run_index(*runs_from_symbols(dec))
    want = jrun.rank_runs(jr.table, jr.seek, sym, pos)
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_split_runs_exact():
    M = run_rank.MAX_RUN
    s2, l2 = run_rank._split_runs(np.array([1, 2, 3], np.uint8),
                                  np.array([M, M + 1, 2 * M], np.int64))
    assert s2.tolist() == [1, 2, 2, 3, 3]
    assert l2.tolist() == [M, M, 1, M, M]
    with pytest.raises(ValueError):
        run_rank._split_runs(np.array([1], np.uint8), np.array([0], np.int64))


@pytest.mark.parametrize("cache_k", [0, 3])
def test_count_kmers_runs_matches_jax(corpus, cache_k):
    dec, jidx, kmers, lengths, want = corpus
    syms, lens = runs_from_symbols(dec)
    jr = jrun.build_run_index(syms, lens.astype(np.int64))
    ridx = run_index_from_numpy(np.asarray(jr.table), np.asarray(jr.seek),
                                np.asarray(jr.starts), jr.n, "cpu")
    cache = jcache = None
    if cache_k:
        jcache = jrun.build_kmer_cache_runs(jr, cache_k)
        cache = run_rank.build_kmer_cache_runs(ridx, cache_k)
        assert np.array_equal(cache.lo.numpy(), np.asarray(jcache.lo))
        assert np.array_equal(cache.hi.numpy(), np.asarray(jcache.hi))
    got = run_rank.count_kmers_runs(ridx, kmers, lengths, cache=cache, cache_k=cache_k)
    assert np.array_equal(got, np.asarray(jrun.count_kmers_runs(
        jr, kmers, lengths, cache=jcache, cache_k=cache_k)))
    assert np.array_equal(got, want)


# --- the tier policy ---


def _tier(bwt):
    if bwt._run_index is not None:
        return "run", bwt._cache_k
    return ("pair" if bwt._pair_index is not None else "packed"), bwt._cache_k


POLICY = {
    # name: (env, patched PAIR_AUTO_MIN_SYMBOLS, expected port tier)
    "small": ({}, None, ("packed", 0)),
    "big": ({}, 1, ("pair", 3)),
    "big_no_cache": ({"MSBWT_TPU_NO_CACHE": "1"}, 1, ("pair", 0)),
    "big_no_pair": ({"MSBWT_TPU_NO_PAIR": "1"}, 1, ("packed", 3)),
    "run_forced": ({"MSBWT_TPU_RUN_TIER": "1"}, None, ("run", 0)),
    "run_forced_big": ({"MSBWT_TPU_RUN_TIER": "1"}, 1, ("run", 2)),
    "over_budget": ({"MSBWT_TPU_DEVICE_BUDGET_GB": "1e-6"}, None, ("run", 0)),
    "over_budget_run_off": ({"MSBWT_TPU_DEVICE_BUDGET_GB": "1e-6",
                             "MSBWT_TPU_RUN_TIER": "0"}, None, ("packed", 0)),
    "budget_fits": ({"MSBWT_TPU_DEVICE_BUDGET_GB": "1"}, 1, ("pair", 3)),
}


@pytest.mark.parametrize("name", list(POLICY))
def test_tier_policy_matches_jax(corpus, monkeypatch, name):
    dec, _, kmers, lengths, want = corpus
    env, min_symbols, expected = POLICY[name]
    for var in ("MSBWT_TPU_NO_PAIR", "MSBWT_TPU_NO_CACHE", "MSBWT_TPU_RUN_TIER",
                "MSBWT_TPU_DEVICE_BUDGET_GB"):
        monkeypatch.delenv(var, raising=False)
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    for cls in (RleBWT, JRleBWT):
        monkeypatch.setattr(cls, "CACHE_AUTO_K", 3)
        monkeypatch.setattr(cls, "RUN_CACHE_AUTO_K", 2)
        if min_symbols is not None:
            monkeypatch.setattr(cls, "PAIR_AUTO_MIN_SYMBOLS", min_symbols)
    payload = bytes_from_runs(*runs_from_symbols(dec))
    port, ref = RleBWT(device="cpu"), JRleBWT()
    port.load_vector(payload)
    ref.load_vector(payload)
    got = port.count_kmers(kmers, lengths)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref.count_kmers(kmers, lengths))
    assert _tier(port) == _tier(ref) == expected
    assert port._auto_run_tier() == ref._auto_run_tier()


def test_auto_run_tier_prices_pair_under_no_pair(corpus, monkeypatch):
    """Mirrors the JAX package: with ``MSBWT_TPU_NO_PAIR=1`` the decoded
    tiers are still priced at 9 B a position, so a budget the packed tier
    alone fits (1 B a position here) still switches to the run tier."""
    dec = corpus[0]
    n = dec.size
    monkeypatch.setenv("MSBWT_TPU_NO_PAIR", "1")
    monkeypatch.setenv("MSBWT_TPU_DEVICE_BUDGET_GB", str(2 * n / 1e9))
    monkeypatch.delenv("MSBWT_TPU_RUN_TIER", raising=False)
    payload = bytes_from_runs(*runs_from_symbols(dec))
    port, ref = RleBWT(device="cpu"), JRleBWT()
    port.load_vector(payload)
    ref.load_vector(payload)
    assert port._auto_run_tier() and ref._auto_run_tier()


def test_dynamic_policy_matches_jax(corpus, monkeypatch):
    """DynamicBWT: pair index + auto cache from PAIR_AUTO_MIN_SYMBOLS on,
    both rebuilt after an insert; counts equal the JAX engine's."""
    dec, _, kmers, lengths, want = corpus
    for var in ("MSBWT_TPU_NO_PAIR", "MSBWT_TPU_NO_CACHE"):
        monkeypatch.delenv(var, raising=False)
    for cls in (RleBWT, JRleBWT):
        monkeypatch.setattr(cls, "PAIR_AUTO_MIN_SYMBOLS", 1)
        monkeypatch.setattr(cls, "CACHE_AUTO_K", 2)
    payload = bytes_from_runs(*runs_from_symbols(dec))
    port, ref = DynamicBWT(device="cpu"), JDynamicBWT()
    port.load_vector(payload)
    ref.load_vector(payload)
    got = port.count_kmers(kmers, lengths)
    assert np.array_equal(got, want)
    assert np.array_equal(got, ref.count_kmers(kmers, lengths))
    assert port._pair is not None and port._cache_k == ref._cache_k == 2
    # an insert drops the pair index and the cache; the next query rebuilds
    # both (held against the port's packed tier: no JAX build compiles here)
    port.insert_strings([convert_stoi("ACGTTGCAACGTAC"), convert_stoi("GATTACAGATTACA")], True)
    assert port.get_total_size() == dec.size + 30
    assert port._pair is None and port._kmer_cache is None
    got = port.count_kmers(kmers, lengths)
    assert port._pair is not None and port._pair.n == dec.size + 30
    assert np.array_equal(got, count_kmers_packed(port.packed_index, kmers, lengths))


# --- query-index packs ---


def _engines(dec):
    payload = bytes_from_runs(*runs_from_symbols(dec))
    port, ref = RleBWT(device="cpu"), JRleBWT()
    port.load_vector(payload)
    ref.load_vector(payload)
    return port, ref


@pytest.mark.parametrize("contents", ["packed", "pair_cache"])
def test_query_pack_jax_to_port(corpus, tmp_path, contents):
    dec, _, kmers, lengths, want = corpus
    port, ref = _engines(dec)
    if contents == "pair_cache":
        ref.enable_pair_index()
        ref.enable_kmer_cache(3)
    path = str(tmp_path / "jax.pack")
    ref.save_query_indexes(path)
    port.load_query_indexes(path)
    assert (port._pair_index is not None) == (contents == "pair_cache")
    if contents == "pair_cache":
        assert port._cache_k == 3
        assert np.array_equal(port._pair_index.table2.numpy(),
                              np.asarray(ref._pair_index.table2))
    assert np.array_equal(port.count_kmers(kmers, lengths), want)
    assert port._device_index is None  # answered from the pack alone


@pytest.mark.parametrize("contents", ["packed", "pair_cache"])
def test_query_pack_port_to_jax(corpus, tmp_path, contents):
    dec, _, kmers, lengths, want = corpus
    port, ref = _engines(dec)
    if contents == "pair_cache":
        port.enable_pair_index()
        port.enable_kmer_cache(3)
    path = str(tmp_path / "port.pack")
    port.save_query_indexes(path)
    with np.load(path) as z:
        keys = set(z.files)
    assert ("pair_table2" in keys) == (contents == "pair_cache")
    assert ("packed_table" in keys) == (contents == "packed")  # what was built
    ref.load_query_indexes(path)
    assert np.array_equal(ref.count_kmers(kmers, lengths), want)
    fresh = RleBWT(device="cpu")
    fresh.load_vector(port.bwt)
    fresh.load_query_indexes(path)
    assert np.array_equal(fresh.count_kmers(kmers, lengths), want)


@pytest.mark.parametrize("bad", ["other_bwt", "legacy_rows", "not_a_pack", "empty"])
def test_query_pack_rejects(corpus, tmp_path, bad):
    dec = corpus[0]
    port, ref = _engines(dec)
    path = str(tmp_path / "bad.pack")
    if bad == "other_bwt":
        other, _ = _engines(dec[:-1])
        other.save_query_indexes(path)
    elif bad == "legacy_rows":
        packed = j_pack_index(jrank.build_occ_index(dec))
        pair = jpair.PairIndex(table2=np.zeros((24, 128), np.int32), starts=packed.starts,
                               dmat=np.zeros(36, np.int32), n=packed.n)
        jckpt.save_query_pack(path, pair=pair)
    else:
        fmt = "something.else" if bad == "not_a_pack" else checkpoint.QUERY_PACK_FORMAT
        with open(path, "wb") as fh:
            np.savez(fh, format=np.asarray(fmt), n=np.int64(dec.size),
                     starts=np.zeros(7, np.int32))
    with pytest.raises(OSError):
        port.load_query_indexes(path)


def test_index_cache_and_shards_cross_load(corpus, tmp_path):
    dec, jidx, *_ = corpus
    p = str(tmp_path / "idx.npz")
    jckpt.save_index_cache(jidx, p)
    idx = checkpoint.load_index_cache(p, device="cpu")
    assert idx.n == jidx.n and np.array_equal(idx.occ.numpy(), np.asarray(jidx.occ))
    checkpoint.save_index_cache(idx, p)
    back = jckpt.load_index_cache(p)
    assert np.array_equal(np.asarray(back.bwt), np.asarray(jidx.bwt))
    checkpoint.save_sharded(dec, str(tmp_path / "sh"), 3)
    assert np.array_equal(jckpt.load_sharded(str(tmp_path / "sh")), dec)
    assert checkpoint.load_manifest(str(tmp_path / "sh")) == jckpt.load_manifest(
        str(tmp_path / "sh"))


# --- the parity FM tables ---


@pytest.mark.parametrize("bin_power", sorted(_PINNED))
def test_fm_index_pinned_tables(bin_power):
    """The reference's pinned tables (ref: src/rle_bwt.rs:536-599)."""
    compressed = convert_to_vec("GTN$$ACCC$G")
    bwt = RleBWT.with_bin_power(bin_power, device="cpu")
    bwt.load_vector(compressed)
    exp_ref, exp_fm = _PINNED[bin_power]
    assert bwt.ref_index.tolist() == exp_ref
    assert bwt.fm_index.tolist() == exp_fm
    for sym in range(VC_LEN):  # host constrain_range over the whole BWT
        assert bwt.constrain_range(sym, BWTRange(0, 11)) == BWTRange(
            int(bwt.start_index[sym]), int(bwt.end_index[sym]))


@pytest.mark.parametrize("bin_power", [1, 3, 8])
def test_fm_index_matches_jax(corpus, bin_power):
    from rust_msbwt_tpu.models.rle_bwt import build_sampled_fm_index as j_fm

    payload = bytes_from_runs(*runs_from_symbols(corpus[0]))
    for rle in (payload, payload[:1], payload[:0]):
        ref, fm = build_sampled_fm_index(rle, bin_power)
        jref, jfm = j_fm(rle, bin_power)
        assert ref.dtype == jref.dtype and np.array_equal(ref, jref)
        assert fm.dtype == jfm.dtype and np.array_equal(fm, jfm)
    port, jax_engine = _engines(corpus[0])
    assert port.n_runs == jax_engine.n_runs
    assert np.array_equal(port.end_index, jax_engine.end_index)
