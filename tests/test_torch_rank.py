"""The port's occurrence index, ranks, prefix cache and packed k-mer counts
against the JAX package, on CPU.

Seeded random BWTs (numpy) — including lengths with ``n % 128 == 0`` and
PAD tails — go through both packages; every comparison is bit-exact
(tolerance 0).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rust_msbwt_tpu.ops import packed_rank as jpr
from rust_msbwt_tpu.ops import rank as jrank

from rust_msbwt_tpu_torch.ops import packed_rank as pr
from rust_msbwt_tpu_torch.ops import rank
from rust_msbwt_tpu_torch.utils.convert import occ_index_from_numpy, packed_index_from_numpy

from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

SIZES = [0, 1, 127, 128, 129, 256, 1000, 4096]


def _bwt(n, seed):
    r = np.random.default_rng(seed)
    return r.integers(0, 6, n).astype(np.uint8)


def _queries(n, B, seed):
    r = np.random.default_rng(seed)
    sym = r.integers(0, 6, B).astype(np.int32)
    pos = r.integers(0, n + 1, B).astype(np.int32)
    pos[:2] = [0, n]  # both ends, incl. pos == n at a bin boundary
    return sym, pos


@pytest.mark.parametrize("n", SIZES)
def test_build_occ_index_matches_jax(n):
    dec = _bwt(n, n)
    idx = rank.build_occ_index(dec, device="cpu")
    jidx = jrank.build_occ_index(dec)
    assert idx.n == jidx.n
    assert np.array_equal(idx.bwt.numpy(), np.asarray(jidx.bwt))
    assert np.array_equal(idx.occ.numpy(), np.asarray(jidx.occ))
    assert np.array_equal(idx.starts.numpy(), np.asarray(jidx.starts))


def test_build_occ_index_prefix_of_longer_buffer():
    """``n`` shorter than the array: the tail reads as PAD (a build buffer)."""
    dec = np.concatenate([_bwt(300, 1), np.full(84, 7, np.uint8)])
    idx = rank.build_occ_index(torch.from_numpy(dec), 300)
    jidx = jrank.build_occ_index(jnp.asarray(dec), 300)
    assert np.array_equal(idx.occ.numpy(), np.asarray(jidx.occ))
    assert np.array_equal(idx.bwt.numpy(), np.asarray(jidx.bwt))


@pytest.mark.parametrize("n", [1, 128, 1000, 4096])
def test_rank_and_constrain_range_match_jax(n):
    dec = _bwt(n, n + 1)
    idx = rank.build_occ_index(dec, device="cpu")
    jidx = jrank.build_occ_index(dec)
    sym, pos = _queries(n, 300, n)
    got = rank.rank(idx, torch.from_numpy(sym), torch.from_numpy(pos))
    want = jrank.rank(jidx, jnp.asarray(sym), jnp.asarray(pos))
    assert np.array_equal(got.numpy(), np.asarray(want))
    lo, hi = np.sort(np.stack([pos, pos[::-1]]), axis=0)
    glo, ghi = rank.constrain_range(idx, torch.from_numpy(sym), torch.from_numpy(lo),
                                    torch.from_numpy(hi))
    wlo, whi = jrank.constrain_range(jidx, jnp.asarray(sym), jnp.asarray(lo),
                                     jnp.asarray(hi))
    assert np.array_equal(glo.numpy(), np.asarray(wlo))
    assert np.array_equal(ghi.numpy(), np.asarray(whi))


@pytest.mark.parametrize("n", SIZES)
def test_pack_index_matches_jax(n):
    dec = _bwt(n, n + 2)
    pidx = pr.pack_index(rank.build_occ_index(dec, device="cpu"))
    jpidx = jpr.pack_index(jrank.build_occ_index(dec))
    assert pidx.n == jpidx.n
    assert np.array_equal(pidx.table.numpy(), np.asarray(jpidx.table))
    assert np.array_equal(pidx.counts.numpy(), np.asarray(jpidx.counts))


@pytest.mark.parametrize("n", [1, 127, 128, 256, 1000, 4096])
def test_rank_packed_matches_jax(n):
    dec = _bwt(n, n + 3)
    jpidx = jpr.pack_index(jrank.build_occ_index(dec))
    table = packed_index_from_numpy(np.asarray(jpidx.table), np.asarray(jpidx.starts),
                                    n, "cpu").table
    sym, pos = _queries(n, 500, n + 4)
    got = pr.rank_packed(table, torch.from_numpy(sym), torch.from_numpy(pos))
    want = jpr.rank_packed(jpidx.table, jnp.asarray(sym), jnp.asarray(pos))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_popcount_swar():
    r = np.random.default_rng(5)
    x = np.concatenate([r.integers(0, 2**32, 1000), [0, 1, 2**31, 2**32 - 1]])
    got = pr.popcount(torch.from_numpy(x.astype(np.int64))).numpy()
    assert got.tolist() == [bin(int(v)).count("1") for v in x]


@pytest.mark.parametrize("cache_k", [1, 2, 3, 4])
def test_kmer_cache_matches_jax(cache_k):
    dec = _bwt(700, 9)
    jidx = jrank.build_occ_index(dec)
    idx = occ_index_from_numpy(np.asarray(jidx.bwt), np.asarray(jidx.occ),
                               np.asarray(jidx.starts), jidx.n, "cpu")
    cache = rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, cache_k)
    jcache = jrank.build_kmer_cache(jidx.bwt, jidx.occ, jidx.starts, jidx.n, cache_k)
    assert np.array_equal(cache.table.numpy(), np.asarray(jcache.table))


def test_kmer_cache_depth_limit():
    """Caches of every depth >= 1 build (6^9 against the JAX package in
    tests/test_torch_query_tiers.py); depth 0 is refused."""
    idx = rank.build_occ_index(_bwt(10, 1), device="cpu")
    with pytest.raises(ValueError):
        rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, 0)


@pytest.mark.parametrize("n,cache_k", [(128, 0), (1000, 0), (1000, 3), (4096, 4), (4096, 0)])
def test_count_kmers_packed_matches_jax(n, cache_k):
    dec = _bwt(n, n + cache_k)
    r = np.random.default_rng(n)
    # draw k-mers from the BWT itself so most have non-zero counts
    starts = r.integers(0, n - 8, 200)
    kmers = dec[starts[:, None] + np.arange(8)[None, :]]
    kmers = np.vstack([kmers, r.integers(0, 6, (50, 8))]).astype(np.uint8)
    lengths = r.integers(1, 9, kmers.shape[0]).astype(np.int32)
    pidx = pr.pack_index(rank.build_occ_index(dec, device="cpu"))
    jidx = jrank.build_occ_index(dec)
    jpidx = jpr.pack_index(jidx)
    cache = jcache = None
    if cache_k:
        idx = rank.build_occ_index(dec, device="cpu")
        cache = rank.build_kmer_cache(idx.bwt, idx.occ, idx.starts, n, cache_k)
        jcache = jrank.build_kmer_cache(jidx.bwt, jidx.occ, jidx.starts, n, cache_k)
    got = pr.count_kmers_packed(pidx, kmers, lengths, cache=cache, cache_k=cache_k)
    want = jpr.count_kmers_packed(jpidx, kmers, lengths, cache=jcache, cache_k=cache_k)
    assert got.dtype == np.int64
    assert np.array_equal(got, np.asarray(want))
    # and the plain occ-index path of the JAX package agrees too
    assert np.array_equal(got, jrank.count_kmers(jidx, kmers, lengths))


def test_count_kmers_packed_rejects_bad_symbols():
    pidx = pr.pack_index(rank.build_occ_index(_bwt(10, 2), device="cpu"))
    with pytest.raises(ValueError):
        pr.count_kmers_packed(pidx, np.array([[1, 6]], np.uint8))


def test_fetch_counts():
    out = rank.fetch_counts(torch.tensor([3, 0, 70000], dtype=torch.int32))
    assert out.dtype == np.int64 and out.tolist() == [3, 0, 70000]
