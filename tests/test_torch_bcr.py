"""The port's build -> index -> count slice against the JAX package, on CPU.

The same seeded reads (numpy) go through the JAX builder (XLA engine; one
case through the Pallas engine in interpret mode) and through the port's
``build_msbwt_with_index(device="cpu")``, which runs the merge kernel's
plain twin. Every comparison is bit-exact (tolerance 0): BWT bytes, ``occ``,
``starts``, the packed table, and k-mer counts with and without a prefix
cache. The naive rotation-sort oracle checks both.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.models.dynamic import DynamicBWT as JDynamicBWT
from rust_msbwt_tpu.models.rle_bwt import RleBWT as JRleBWT
from rust_msbwt_tpu.ops import bcr as jbcr
from rust_msbwt_tpu.ops.packed_rank import count_kmers_packed as j_count_packed
from rust_msbwt_tpu.ops.rank import build_kmer_cache as j_build_cache
from rust_msbwt_tpu.utils.oracle import naive_bwt

from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT, create_from_fastx
from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
from rust_msbwt_tpu_torch.ops.rank import build_kmer_cache
from rust_msbwt_tpu_torch.ops.rle import bytes_from_runs, runs_from_symbols

from tests._data import GOLDEN_FA
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _reads(kind, seed):
    r = np.random.default_rng(seed)
    if kind == "equal":
        return [r.integers(1, 6, 24).astype(np.uint8) for _ in range(40)]
    if kind == "ragged":
        return [r.integers(1, 6, r.integers(1, 30)).astype(np.uint8) for _ in range(40)]
    if kind == "duplicates":  # few distinct reads, many copies, tandem repeats
        base = [np.tile(r.integers(1, 6, r.integers(1, 4)), 6)[: r.integers(3, 20)]
                .astype(np.uint8) for _ in range(5)]
        return [base[i] for i in r.integers(0, 5, 40)]
    raise ValueError(kind)


def _port_build(reads_l, sorted_insert):
    reads, lengths = bcr.encode_reads(reads_l)
    return bcr.build_msbwt_with_index(reads, lengths, sorted_insert, device="cpu")


def _jax_build(reads_l, sorted_insert, engine="xla"):
    reads, lengths = jbcr.encode_reads(reads_l)
    return jbcr.build_msbwt_with_index(reads, lengths, sorted_insert, engine=engine)


def _assert_same_index(port, jax_):
    (idx, packed), (jidx, jpacked) = port, jax_
    assert idx.n == jidx.n
    assert np.array_equal(idx.bwt.numpy(), np.asarray(jidx.bwt))
    assert np.array_equal(idx.occ.numpy(), np.asarray(jidx.occ))
    assert np.array_equal(idx.starts.numpy(), np.asarray(jidx.starts))
    assert np.array_equal(packed.table.numpy(), np.asarray(jpacked.table))
    assert np.array_equal(packed.starts.numpy(), np.asarray(jpacked.starts))


@pytest.mark.parametrize("kind", ["equal", "ragged", "duplicates"])
@pytest.mark.parametrize("sorted_insert", [True, False])
def test_build_with_index_matches_jax(kind, sorted_insert):
    reads_l = _reads(kind, seed=len(kind) + 7 * sorted_insert)
    port = _port_build(reads_l, sorted_insert)
    _assert_same_index(port, _jax_build(reads_l, sorted_insert))
    if sorted_insert:
        got = convert_itos(port[0].bwt[: port[0].n].numpy())
        assert got == naive_bwt([convert_itos(s) for s in reads_l])


def test_build_matches_jax_pallas_engine():
    """One case against the JAX package's own kernel (Pallas interpret mode)."""
    r = np.random.default_rng(300)
    reads_l = [r.integers(1, 6, 40).astype(np.uint8) for _ in range(300)]
    _assert_same_index(_port_build(reads_l, True), _jax_build(reads_l, True, "pallas"))


@pytest.mark.parametrize("seed", range(4))
def test_build_msbwt_matches_naive(seed):
    r = np.random.default_rng(seed)
    reads_l = [r.integers(1, 6, r.integers(1, 12)).astype(np.uint8)
               for _ in range(r.integers(1, 9))]
    reads, lengths = bcr.encode_reads(reads_l)
    got = convert_itos(bcr.build_msbwt(reads, lengths, device="cpu"))
    assert got == naive_bwt([convert_itos(s) for s in reads_l])


def test_build_empty_matches_jax():
    reads, lengths = bcr.encode_reads([])
    idx, packed = bcr.build_msbwt_with_index(reads, lengths, device="cpu")
    jidx, jpacked = jbcr.build_msbwt_with_index(*jbcr.encode_reads([]))
    assert idx.n == jidx.n == 0
    assert np.array_equal(packed.table.numpy(), np.asarray(jpacked.table))


@pytest.mark.parametrize("cache_k", [0, 3])
def test_count_kmers_on_build_matches_jax(cache_k):
    reads_l = _reads("ragged", seed=11)
    idx, packed = _port_build(reads_l, True)
    jidx, jpacked = _jax_build(reads_l, True)
    r = np.random.default_rng(12)
    # half taken from the reads (they occur), half random
    kmers = np.stack([np.tile(reads_l[i], 6)[:6] for i in r.integers(0, len(reads_l), 50)]
                     + [r.integers(0, 6, 6) for _ in range(50)]).astype(np.uint8)
    lengths = r.integers(1, 7, kmers.shape[0]).astype(np.int32)
    for i, ln in enumerate(lengths):
        kmers[i, : 6 - ln] = 0
    cache = jcache = None
    if cache_k:
        cache = build_kmer_cache(idx.bwt, idx.occ, idx.starts, idx.n, cache_k)
        jcache = j_build_cache(jidx.bwt, jidx.occ, jidx.starts, jidx.n, cache_k)
    got = count_kmers_packed(packed, kmers, lengths, cache=cache, cache_k=cache_k)
    want = j_count_packed(jpacked, kmers, lengths, cache=jcache, cache_k=cache_k)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("N,L,n_cap,chunk", [(10, 20, 220, 16), (300, 40, 12300, 128),
                                             (5_000_000, 100, 505_000_000, 128),
                                             (7, 3, 20, 128)])
def test_bucket_schedule_matches_jax(N, L, n_cap, chunk):
    assert bcr.bucket_schedule(0, N, L, n_cap, chunk) == jbcr.bucket_schedule(
        0, N, L, n_cap, chunk, growth=1.3)


@pytest.mark.parametrize("kind", ["equal", "ragged"])
def test_encode_reads_matches_jax(kind):
    reads_l = _reads(kind, seed=9)
    got, want = bcr.encode_reads(reads_l), jbcr.encode_reads(reads_l)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    bad = reads_l[:3] + [np.concatenate([reads_l[3][:5], [0], reads_l[3][6:]])]
    for encode in (bcr.encode_reads, jbcr.encode_reads):
        with pytest.raises(ValueError):
            encode(bad)


def test_host_prep_matches_jax():
    reads_l = _reads("ragged", seed=5)
    reads, lengths = bcr.encode_reads(reads_l)
    jreads, jlengths = jbcr.encode_reads(reads_l)
    assert np.array_equal(reads, jreads) and np.array_equal(lengths, jlengths)
    s, sl = bcr.sort_reads(reads, lengths)
    js, jsl = jbcr.sort_reads(reads, lengths)
    assert np.array_equal(s, js) and np.array_equal(sl, jsl)
    assert np.array_equal(bcr.reads_to_cols(s, sl), jbcr.reads_to_cols(s, sl))


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_dynamic_bwt_matches_jax(sorted_insert):
    reads_l = [convert_itos(s) for s in _reads("ragged", seed=21)[:12]]
    port, ref = DynamicBWT(device="cpu"), JDynamicBWT()
    for s in reads_l:
        port.insert_string(s, sorted_insert)
        ref.insert_string(s, sorted_insert)
    assert np.array_equal(port.to_vec(), ref.to_vec())
    assert np.array_equal(port.get_symbol_counts(), ref.get_symbol_counts())
    kmers = np.array([convert_stoi(s[:3]) for s in reads_l if len(s) >= 3])
    assert np.array_equal(port.count_kmers(kmers), ref.count_kmers(kmers))
    assert port.count_kmer(kmers[0]) == ref.count_kmer(kmers[0])
    port.enable_kmer_cache(2)
    assert np.array_equal(port.count_kmers(kmers), ref.count_kmers(kmers))


def test_create_from_fastx_golden():
    bwt = create_from_fastx([GOLDEN_FA], device="cpu")
    assert convert_itos(bwt.to_vec()) == "TAC$GATCG$"
    assert bwt.string_count == 2


@pytest.mark.parametrize("cache_k", [0, 2])
def test_rle_bwt_matches_jax(cache_k):
    reads_l = _reads("duplicates", seed=31)
    idx, _ = _port_build(reads_l, True)
    rle = bytes_from_runs(*runs_from_symbols(idx.bwt[: idx.n].numpy()))
    port, ref = RleBWT(device="cpu"), JRleBWT()
    port.load_vector(rle)
    ref.load_vector(rle)
    if cache_k:
        port.enable_kmer_cache(cache_k)
        ref.enable_kmer_cache(cache_k)
    r = np.random.default_rng(32)
    kmers = r.integers(1, 6, (60, 4)).astype(np.uint8)
    assert np.array_equal(port.count_kmers(kmers), ref.count_kmers(kmers))
    assert [port.count_kmer(k) for k in kmers[:10]] == [ref.count_kmer(k) for k in kmers[:10]]
    assert np.array_equal(port.packed_index.table.numpy(),
                          np.asarray(ref.packed_index.table))
    assert port.get_total_size() == ref.get_total_size()
    assert torch.equal(port.device_index.starts,
                       torch.from_numpy(np.array(ref.device_index.starts)))
