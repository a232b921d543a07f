"""The query kernels' plain twins (``ops/query.py``) against the JAX
package, on CPU.

On CPU tensors ``kmer_ranges_packed`` and ``kmer_counts_pair`` run their
plain PyTorch twins and launch nothing. The dispatchers
``packed_rank._kmer_ranges_packed_impl`` and
``pair_rank._count_kmers_pair_impl`` are held against the JAX package's
functions of the same names on the same seeded inputs: ragged lengths
0..K in one batch (odd and even remainders), K = 1, 2 and 21, prefix
caches of depth 0, 8 and 9 built by the JAX package, queries shorter than
the cache through ``count_batch``, a batch of no queries, every query
absent, and an index of n % 128 == 0 symbols (there the pair tier is held
against the packed tier: the JAX pair reader reads past its table at hi
== n, see tests/test_torch_query_tiers.py). The same cases run on the
card, kernel against twin, in tests/test_torch_gpu.py. Every output is an
integer: bit-exact throughout (tolerance 0). The group-edge cases of the
kernels (warps that mix early stops, full queries and one-symbol tails;
batch sizes at the edges of the lane groups, warps and blocks) run here
against the JAX functions too, and a replay checks that the cases put lo
and hi in one row, in adjacent rows, rows apart and hi at n.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.ops import packed_rank as jpacked
from rust_msbwt_tpu.ops import pair_rank as jpair
from rust_msbwt_tpu.ops import rank as jrank

from rust_msbwt_tpu_torch.ops import packed_rank, pair_rank, query
from rust_msbwt_tpu_torch.utils.convert import kmer_cache_from_numpy
from test_torch_gpu import QUERY_KINDS, QUERY_SIZE_CASES, query_calls, query_case
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _launches():
    return tuple(w.launches for w in query.QUERY_KERNELS)


def _jax_indexes(dec):
    jidx = jrank.build_occ_index(dec)
    return jidx, jpacked.pack_index(jidx), jpair.build_pair_index(jidx)


def _jax_search(jpk, jp, kmers, lengths, jcache=None, cache_k=0):
    """The JAX package's packed ranges and pair counts of a batch."""
    lo, hi = jpacked._kmer_ranges_packed_impl(jpk.table, jpk.starts, jpk.n, kmers, lengths,
                                              cache=jcache, cache_k=cache_k)
    counts = jpair._count_kmers_pair_impl(jp.table2, jp.starts, jp.dmat, jp.n, kmers,
                                          lengths, cache=jcache, cache_k=cache_k)
    return np.asarray(lo), np.asarray(hi), np.asarray(counts)


@pytest.fixture(scope="module")
def ragged():
    """The ``ragged`` case's BWT (n = 25,755) in both packages, and its 6^8
    and 6^9 prefix caches built by the JAX package (for both)."""
    dec = query_case("ragged")["dec"]
    jidx, jpk, jp = _jax_indexes(dec)
    caches = {}
    for k in (8, 9):
        jc = jrank.build_kmer_cache(jidx.bwt, jidx.occ, jidx.starts, jidx.n, k)
        caches[k] = (jc, kmer_cache_from_numpy(np.asarray(jc.lo), np.asarray(jc.hi), "cpu"))
    return jpk, jp, caches


@pytest.mark.parametrize("kind", QUERY_KINDS)
def test_query_wrappers_on_cpu_run_plain(kind):
    """On CPU tensors each wrapper runs its plain twin (no launch), and the
    result equals the JAX package's: ``one``, ``empty`` (B = 0), ``absent``
    (every count 0), ``aligned`` (n % 128 == 0: the packed tier against
    JAX, the pair tier against the packed tier) and ``ragged``."""
    case = query_case(kind)
    B = case["kmers"].shape[0]
    calls = query_calls(case, "cpu")
    before = _launches()
    out = {}
    for tier, (wrapper, plain, args) in calls.items():
        got = wrapper(*args)
        got = got if isinstance(got, tuple) else (got,)
        want = plain(*args)
        want = want if isinstance(want, tuple) else (want,)
        assert all(g.dtype == torch.int32 and g.shape == (B,) and torch.equal(g, w)
                   for g, w in zip(got, want)), tier
        out[tier] = [g.numpy() for g in got]
    assert _launches() == before
    (lo, hi), (counts,) = out["packed"], out["pair"]
    assert np.array_equal(counts, hi - lo)
    if kind == "absent":
        assert not counts.any()
    if B:
        _, jpk, jp = _jax_indexes(case["dec"])
        jlo, jhi, jcounts = _jax_search(jpk, jp, case["kmers"], case["lengths"])
        assert np.array_equal(lo, jlo) and np.array_equal(hi, jhi)
        if kind != "aligned":
            assert np.array_equal(counts, jcounts)


@pytest.mark.parametrize("cache_k", [0, 8, 9])
@pytest.mark.parametrize("K", [1, 2, 21])
def test_dispatchers_match_jax(ragged, K, cache_k):
    """Both dispatchers on CPU tensors == the JAX functions: the packed
    tier's lo and hi, the pair tier's counts; K = 1 and 2 take no cache
    (K < cache_k), K = 21 starts from it (lengths cache_k..21: 21 - cache_k
    is even at 9 and odd at 8, so both the pair tier's last rounds run)."""
    jpk, jp, caches = ragged
    case = query_case("ragged", cache_k)
    kmers = np.ascontiguousarray(case["kmers"][:512, 21 - K:])
    lengths = np.minimum(case["lengths"][:512], K)
    if K < 21:  # ragged 0..K
        lengths = np.random.default_rng(K).integers(0, K + 1, 512).astype(np.int32)
        kmers[np.arange(K)[None, :] < (K - lengths)[:, None]] = 0
    jcache, cache = caches.get(cache_k, (None, None))
    km, ln = torch.from_numpy(kmers), torch.from_numpy(lengths)
    calls = query_calls(dict(case, cache_k=0), "cpu")
    packed_args, pair_args = calls["packed"][2], calls["pair"][2]
    before = _launches()
    lo, hi = packed_rank._kmer_ranges_packed_impl(*packed_args[:3], km, ln, cache=cache,
                                                  cache_k=cache_k)
    counts = pair_rank._count_kmers_pair_impl(*pair_args[:4], km, ln, cache=cache,
                                              cache_k=cache_k)
    assert _launches() == before
    jlo, jhi, jcounts = _jax_search(jpk, jp, kmers, lengths, jcache, cache_k)
    assert np.array_equal(lo.numpy(), jlo) and np.array_equal(hi.numpy(), jhi)
    assert np.array_equal(counts.numpy(), jcounts)
    assert np.array_equal(counts.numpy(), jhi - jlo)


@pytest.mark.parametrize("tier", ["packed", "pair"])
def test_count_batch_short_queries_match_jax(ragged, tier):
    """``count_batch`` with the JAX package's 6^8 cache and lengths 0..21:
    queries shorter than 8 take the uncached search; every count equals
    the JAX package's uncached count."""
    from rust_msbwt_tpu_torch.ops.bcr import index_from_symbols

    jpk, jp, caches = ragged
    case = query_case("ragged")
    kmers, lengths = case["kmers"][:600], case["lengths"][:600]
    assert (lengths < 8).any() and (lengths >= 8).any()
    idx, packed = index_from_symbols(torch.from_numpy(case["dec"]))
    cache = caches[8][1]
    before = _launches()
    got = (packed_rank.count_kmers_packed(packed, kmers, lengths, cache=cache, cache_k=8)
           if tier == "packed" else
           pair_rank.count_kmers_pair(pair_rank.build_pair_index(idx), kmers, lengths,
                                      cache=cache, cache_k=8))
    assert _launches() == before
    jlo, jhi, _ = _jax_search(jpk, jp, kmers, lengths)
    assert got.dtype == np.int64 and np.array_equal(got, jhi - jlo)



def _batch_matches_jax(ragged, case):
    """The case's batch through both dispatchers on CPU tensors (no launch)
    == the JAX functions, with the JAX package's cache of the case's
    depth (0, 8 or 9)."""
    jpk, jp, caches = ragged
    ck = case["cache_k"]
    jcache, cache = caches.get(ck, (None, None))
    km, ln = torch.from_numpy(case["kmers"]), torch.from_numpy(case["lengths"])
    calls = query_calls(dict(case, cache_k=0), "cpu")
    before = _launches()
    lo, hi = packed_rank._kmer_ranges_packed_impl(*calls["packed"][2][:3], km, ln, cache=cache,
                                                  cache_k=ck)
    counts = pair_rank._count_kmers_pair_impl(*calls["pair"][2][:4], km, ln, cache=cache,
                                              cache_k=ck)
    assert _launches() == before
    jlo, jhi, jcounts = _jax_search(jpk, jp, case["kmers"], case["lengths"], jcache, ck)
    assert np.array_equal(lo.numpy(), jlo) and np.array_equal(hi.numpy(), jhi)
    assert np.array_equal(counts.numpy(), jcounts)


@pytest.mark.parametrize("B,cache_k", QUERY_SIZE_CASES)
def test_group_sizes_match_jax(ragged, B, cache_k):
    """Batch sizes at the edges of the kernels' lane groups, warps and
    blocks, uncached and from the 6^9 cache: == the JAX functions."""
    _batch_matches_jax(ragged, query_case("ragged", cache_k, B=B))


@pytest.mark.parametrize("cache_k", [8, 9])
def test_mixed_warp_matches_jax(ragged, cache_k):
    """Each four queries an early stop, a full query, one of the other
    parity and a one-step tail, from the 6^8 and 6^9 caches: == the JAX
    functions (the uncached batch runs in
    ``test_query_wrappers_on_cpu_run_plain``)."""
    _batch_matches_jax(ragged, query_case("mixed", cache_k))


def _row_relations(case) -> set:
    """How lo's and hi's rows stand before each active step of the case's
    packed search (the plain replay on the CPU): in one row, in adjacent
    rows, rows apart, and hi == n."""
    from rust_msbwt_tpu_torch.ops.bcr import index_from_symbols
    from rust_msbwt_tpu_torch.ops.packed_rank import rank_packed

    _, packed = index_from_symbols(torch.from_numpy(case["dec"]))
    km, ln = torch.from_numpy(case["kmers"]), torch.from_numpy(case["lengths"])
    B, K = km.shape
    lo = torch.zeros(B, dtype=torch.int32)
    hi = torch.full((B,), packed.n, dtype=torch.int32)
    seen = set()
    for t in range(K):
        act = t < ln
        d = (hi >> 7) - (lo >> 7)
        for name, m in (("one row", d == 0), ("adjacent rows", d == 1), ("rows apart", d > 1),
                        ("hi == n", hi == packed.n)):
            if bool((m & act).any()):
                seen.add(name)
        s = torch.where(act, km[:, K - 1 - t].to(torch.int32), 0)
        c = packed.starts[s.long()]
        lo, hi = (torch.where(act, c + rank_packed(packed.table, s, x), x) for x in (lo, hi))
    return seen


@pytest.mark.parametrize("kind", ["mixed", "aligned"])
def test_cases_cover_row_edges(kind):
    """The uncached ``mixed`` and ``aligned`` (n % 128 == 0) batches step
    with lo and hi in one row, in adjacent rows and rows apart, and from
    hi == n, so the card tests hold the kernels at every row relation."""
    assert _row_relations(query_case(kind)) == {"one row", "adjacent rows", "rows apart",
                                                "hi == n"}
