"""The port's extend flow against the JAX package, on CPU.

Extending an existing BWT (``build_msbwt(base=...)``), the LF walks it
needs (``terminator_positions``, ``read_lengths_from_bwt``), the device RLE
decode of the load path, and ``DynamicBWT``'s extend, load and segment
flows. The same seeded reads (numpy) go through the JAX package (XLA
engine; one case through the Pallas engine in interpret mode) and through
the port on ``cpu``, which runs the merge kernel's plain twin. Every
comparison is bit-exact (tolerance 0: every output is an integer); the
naive rotation-sort oracle checks both where it applies.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.models.dynamic import DynamicBWT as JDynamicBWT
from rust_msbwt_tpu.ops import bcr as jbcr
from rust_msbwt_tpu.ops.packed_rank import pack_index as j_pack_index
from rust_msbwt_tpu.ops.rank import build_occ_index as j_build_occ_index
from rust_msbwt_tpu.ops.rle import decode_symbols_device as j_decode_device
from rust_msbwt_tpu.utils.oracle import naive_bwt

from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
from rust_msbwt_tpu_torch.ops.rank import build_occ_index
from rust_msbwt_tpu_torch.ops.rle import (
    bytes_from_runs,
    decode_symbols,
    decode_symbols_device,
    rle_meta,
    runs_from_symbols,
)
from rust_msbwt_tpu_torch.utils.convert import dynamic_from_jax
from rust_msbwt_tpu_torch.utils.npy import save_bwt_runs

from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

# two read-matrix shapes for the whole file (JAX compiles per shape):
# base batch [40, <=24], extension batch [24, <=24]
N_BASE, N_NEW, L = 40, 24, 24


def _reads(kind, n, seed):
    r = np.random.default_rng(seed)
    if kind == "equal":
        return [r.integers(1, 6, L).astype(np.uint8) for _ in range(n)]
    if kind == "ragged":
        return [r.integers(1, 6, r.integers(1, L + 1)).astype(np.uint8) for _ in range(n)]
    if kind == "duplicates":  # few distinct reads, many copies
        pool = [r.integers(1, 6, r.integers(1, L + 1)).astype(np.uint8) for _ in range(4)]
        return [pool[i] for i in r.integers(0, 4, n)]
    if kind == "periodic":  # tandem repeats of short periods, many lengths
        pool = [r.integers(1, 3, r.integers(1, 4)).astype(np.uint8) for _ in range(3)]
        return [np.tile(pool[r.integers(0, 3)], L)[: r.integers(1, L + 1)]
                for _ in range(n)]
    raise ValueError(kind)


def _pad(reads_l):
    """Encode to a fixed ``[n, L]`` matrix (one JAX compile per batch size)."""
    reads, lengths = bcr.encode_reads(reads_l)
    out = np.zeros((reads.shape[0], L), np.uint8)
    out[:, : reads.shape[1]] = reads
    return out, lengths


def _case(kind, seed):
    """Base BWT (from N_BASE reads) + the extension batch, both of ``kind``.
    The extension repeats a few base reads so ties between base and new
    terminators are exercised."""
    base_l = _reads(kind, N_BASE, seed)
    new_l = _reads(kind, N_NEW - 4, seed + 1000) + base_l[:4]
    base = bcr.build_msbwt(*_pad(base_l), device="cpu")
    return base_l, new_l, base


KINDS = ["equal", "ragged", "duplicates", "periodic"]


@pytest.mark.parametrize("kind", KINDS)
def test_lf_walks_match_jax(kind):
    base_l, new_l, base = _case(kind, seed=len(kind))
    rot_max = max(len(s) for s in base_l) + 1
    idx = build_occ_index(base, device="cpu")
    jidx = j_build_occ_index(base)
    lengths = bcr.read_lengths_from_bwt(idx, N_BASE)
    assert np.array_equal(lengths, jbcr.read_lengths_from_bwt(jidx, N_BASE))
    assert sorted(lengths.tolist()) == sorted(len(s) for s in base_l)
    reads, lens = bcr.sort_reads(*_pad(new_l))
    got = bcr.terminator_positions(idx, reads, lens, rot_max)
    want = np.asarray(jbcr.terminator_positions(jidx, reads, lens, rot_max))
    assert np.array_equal(got.numpy(), want)
    # a larger bound only adds whole cycles: same ranks
    more = bcr.terminator_positions(idx, reads, lens, rot_max + 7)
    assert torch.equal(more, got)


def _assert_same_index(port, jax_):
    (idx, packed), (jidx, jpacked) = port, jax_
    assert idx.n == jidx.n
    assert np.array_equal(idx.bwt[: idx.n].numpy(), np.asarray(jidx.bwt)[: jidx.n])
    assert np.array_equal(idx.occ.numpy(), np.asarray(jidx.occ))
    assert np.array_equal(idx.starts.numpy(), np.asarray(jidx.starts))
    assert np.array_equal(packed.table.numpy(), np.asarray(jpacked.table))


@pytest.mark.parametrize("kind", ["ragged", "periodic"])
@pytest.mark.parametrize("sorted_insert", [True, False])
def test_build_extend_matches_jax(kind, sorted_insert):
    base_l, new_l, base = _case(kind, seed=7 + len(kind))
    reads, lens = _pad(new_l)
    kw = dict(base_string_count=N_BASE)
    port = bcr.build_msbwt_with_index(reads, lens, sorted_insert, base, device="cpu", **kw)
    want = jbcr.build_msbwt_with_index(reads, lens, sorted_insert, base, engine="xla", **kw)
    _assert_same_index(port, want)
    got = bcr.build_msbwt(reads, lens, sorted_insert, base, device="cpu", **kw)
    assert np.array_equal(got, np.asarray(jbcr.build_msbwt(reads, lens, sorted_insert,
                                                           base, engine="xla", **kw)))
    if sorted_insert:
        assert convert_itos(got) == naive_bwt([convert_itos(s) for s in base_l + new_l])
    # a device-tensor base, its packed index and a known bound: same bytes
    bidx, bpacked = bcr.index_from_symbols(torch.from_numpy(base))
    rot_max = max(len(s) for s in base_l) + 1
    again = bcr.build_msbwt_with_index(reads, lens, sorted_insert, bidx.bwt[: bidx.n],
                                       base_rot_max=rot_max, base_index=bpacked,
                                       device="cpu", **kw)
    assert torch.equal(again[0].bwt, port[0].bwt)
    assert torch.equal(again[1].table, port[1].table)
    on_device = bcr.build_msbwt(reads, lens, sorted_insert, base, device="cpu",
                                device_out=True, **kw)
    assert torch.equal(on_device, torch.from_numpy(got))


def test_build_extend_matches_jax_pallas_engine():
    """One extend against the JAX package's own kernel (Pallas interpret)."""
    base_l, new_l, base = _case("ragged", seed=99)
    reads, lens = _pad(new_l)
    port = bcr.build_msbwt_with_index(reads, lens, True, base, N_BASE, device="cpu")
    want = jbcr.build_msbwt_with_index(reads, lens, True, base, N_BASE, engine="pallas")
    _assert_same_index(port, want)


def test_build_extend_empty_batch_returns_base():
    _, _, base = _case("equal", seed=3)
    reads, lens = bcr.encode_reads([])
    idx, packed = bcr.build_msbwt_with_index(reads, lens, base=base,
                                             base_string_count=N_BASE, device="cpu")
    jidx, jpacked = jbcr.build_msbwt_with_index(reads, lens, base=base,
                                                base_string_count=N_BASE)
    _assert_same_index((idx, packed), (jidx, jpacked))


def test_index_from_symbols_matches_build_occ_index():
    _, _, base = _case("ragged", seed=4)
    for n in (0, 1, 128, base.size):
        idx, packed = bcr.index_from_symbols(torch.from_numpy(base[:n].copy()))
        want = j_build_occ_index(base[:n])
        assert idx.n == n
        assert np.array_equal(idx.bwt.numpy(), np.asarray(want.bwt))
        assert np.array_equal(idx.occ.numpy(), np.asarray(want.occ))
        assert np.array_equal(idx.starts.numpy(), np.asarray(want.starts))
        assert np.array_equal(packed.table.numpy(), np.asarray(j_pack_index(want).table))


@pytest.mark.parametrize("run_len", [1, 40, 3104, 40_000])
def test_decode_symbols_device_matches_jax(run_len):
    # run counts of 1, 2, 3 and 4 base-32 digits
    r = np.random.default_rng(run_len)
    syms = np.arange(300) % 6
    r.shuffle(syms)
    syms = syms[np.r_[True, syms[1:] != syms[:-1]]].astype(np.uint8)
    counts = r.integers(1, run_len + 1, syms.size).astype(np.uint64)
    counts[::7] = run_len
    rle = bytes_from_runs(syms, counts)
    n, _, _ = rle_meta(rle)
    got = decode_symbols_device(rle, n, device="cpu")
    assert np.array_equal(got.numpy(), np.asarray(j_decode_device(rle, n)))
    assert np.array_equal(got.numpy(), decode_symbols(rle))
    assert torch.equal(decode_symbols_device(rle, device="cpu"), got)  # n found on device
    assert decode_symbols_device(rle[:0], device="cpu").numel() == 0
    with pytest.raises(ValueError):
        decode_symbols_device(rle, n + 1, device="cpu")
    with pytest.raises(ValueError):
        decode_symbols_device(rle, 2**31, device="cpu")


# --- DynamicBWT: extend, load and segment flows --------------------------


def test_dynamic_insert_query_insert_matches_jax():
    base_l, new_l, _ = _case("ragged", seed=21)
    port, ref = DynamicBWT(device="cpu"), JDynamicBWT()
    kmers = np.array([np.tile(s, 3)[:3] for s in base_l[:10] + new_l[:10]])
    port.enable_kmer_cache(2)
    ref.enable_kmer_cache(2)
    for batch in (base_l, new_l):
        port.insert_strings(batch, True)
        ref.insert_strings(batch, True)
        # the query after each insert sees the extended BWT (every cached
        # index of the earlier one is dropped, the prefix cache rebuilt)
        assert np.array_equal(port.count_kmers(kmers), ref.count_kmers(kmers))
        assert port.count_kmer(kmers[0]) == ref.count_kmer(kmers[0])
        assert np.array_equal(port.to_vec(), ref.to_vec())
    assert port.string_count == ref.string_count == N_BASE + N_NEW


def test_dynamic_mixed_segments_match_jax():
    r = np.random.default_rng(5)
    ops = [(convert_itos(r.integers(1, 6, r.integers(1, 9))), bool(r.integers(0, 2)))
           for _ in range(14)]
    port, ref = DynamicBWT(device="cpu"), JDynamicBWT()
    for s, flag in ops:
        port.insert_string(s, flag)
        ref.insert_string(s, flag)
    assert np.array_equal(port.to_vec(), ref.to_vec())
    assert list(port.run_iter()) == list(ref.run_iter())


def test_dynamic_load_and_add_pinned_vectors(tmp_path):
    # the reference's load-and-add test (ref: src/dynamic_bwt.rs:734-773),
    # through a saved file as a user loads one
    data = ["CCGTACGTA", "GGTACAGTA", "ACGACGACG"]
    path = str(tmp_path / "comp_msbwt.npy")
    save_bwt_runs(*runs_from_symbols(convert_stoi(naive_bwt(data))), path)
    b = DynamicBWT(device="cpu")
    b.load_numpy_file(path)
    b.insert_string("AAGTCATAT", True)
    data.append("AAGTCATAT")
    for c in range(6):
        assert b.get_symbol_count(c) == b.count_kmer([c])
    for seq in data:
        assert b.count_kmer(convert_stoi(seq)) == 1
    assert b.count_kmer(convert_stoi("ACG")) == 4
    assert b.count_kmer(convert_stoi("CC")) == 1
    assert b.count_kmer(convert_stoi("TAC")) == 2
    assert b.count_kmer(convert_stoi("AA")) == 1
    assert b.count_kmer(convert_stoi("GT")) == 5
    assert convert_itos(b.to_vec()) == naive_bwt(data)


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_dynamic_from_decoded_extend_matches_jax(sorted_insert):
    base_l, new_l, base = _case("periodic", seed=31)
    port = DynamicBWT.from_decoded(base, device="cpu")
    ref = JDynamicBWT.from_decoded(base)
    port.insert_strings(new_l, sorted_insert)
    ref.insert_strings(new_l, sorted_insert)
    assert np.array_equal(port.to_vec(), ref.to_vec())
    assert port.string_count == N_BASE + N_NEW


def test_dynamic_from_jax_state_extends_like_jax():
    base_l, new_l, _ = _case("duplicates", seed=41)
    ref = JDynamicBWT()
    ref.insert_strings(base_l, True)
    ref.to_vec()  # materialize: the state carried across is a built base
    ref.insert_strings(new_l[:5], False)  # and a queued segment
    port = dynamic_from_jax(ref, device="cpu")
    assert port._max_read_len == ref._max_read_len
    for bwt in (port, ref):
        bwt.insert_strings(new_l[5:], True)
    assert np.array_equal(port.to_vec(), ref.to_vec())


def test_dynamic_views_match_jax(tmp_path):
    base_l, _, base = _case("duplicates", seed=51)
    port, ref = DynamicBWT(device="cpu"), JDynamicBWT()
    assert list(port.run_iter()) == list(ref.run_iter()) == []
    assert port.get_height() == ref.get_height() == 0
    rle = bytes_from_runs(*runs_from_symbols(base))
    port.load_vector(rle)
    ref.load_vector(rle)
    assert list(port.iter()) == list(ref.iter())
    assert list(port.run_iter()) == list(ref.run_iter())
    assert port.get_height() == ref.get_height() == 2
    assert port.get_node_count() == ref.get_node_count()
    assert port.get_total_size() == ref.get_total_size() == base.size
    assert np.array_equal(port.get_symbol_counts(), ref.get_symbol_counts())
