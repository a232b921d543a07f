"""The port's host layers against the JAX package's, on CPU: alphabet, RLE
codec, npy container, FASTX parsing, debug checks and the native host
library. Seeded inputs (numpy) go through both; every comparison is exact.
The port's npy writer is byte-identical to ``test_data/two_string.npy``.
"""

import doctest
import gzip
import importlib

import numpy as np
import pytest

from rust_msbwt_tpu.ops import alphabet as jalpha
from rust_msbwt_tpu.ops import rle as jrle
from rust_msbwt_tpu.utils import checks as jchecks
from rust_msbwt_tpu.utils import fastx as jfastx
from rust_msbwt_tpu.utils import native as jnative
from rust_msbwt_tpu.utils import npy as jnpy

from rust_msbwt_tpu_torch.ops import alphabet, rle
from rust_msbwt_tpu_torch.utils import checks, fastx, native, npy

from tests._data import GOLDEN_FA, GOLDEN_NPY
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _symbols(n, seed, run_len=4):
    r = np.random.default_rng(seed)
    return np.repeat(r.integers(0, 6, n), r.integers(1, run_len + 1, n)).astype(np.uint8)


def test_alphabet_matches_jax():
    raw = bytes(np.random.default_rng(1).integers(0, 256, 2000).astype(np.uint8))
    assert np.array_equal(alphabet.convert_stoi(raw), jalpha.convert_stoi(raw))
    syms = np.random.default_rng(2).integers(0, 6, 500)
    assert alphabet.convert_itos(syms) == jalpha.convert_itos(syms)
    assert np.array_equal(alphabet.reverse_complement_i(syms),
                          jalpha.reverse_complement_i(syms))
    for name in ("VC_LEN", "LETTER_BITS", "NUMBER_BITS", "NUM_POWER", "MASK",
                 "COUNT_MASK"):
        assert getattr(alphabet, name) == getattr(jalpha, name)


@pytest.mark.parametrize("n,seed,run_len", [(0, 0, 1), (1, 1, 1), (300, 2, 4),
                                            (2000, 3, 40), (50, 4, 5000)])
def test_rle_matches_jax(n, seed, run_len):
    dec = _symbols(n, seed, run_len)
    syms, counts = rle.runs_from_symbols(dec)
    jsyms, jcounts = jrle.runs_from_symbols(dec)
    assert np.array_equal(syms, jsyms) and np.array_equal(counts, jcounts)
    enc = rle.bytes_from_runs(syms, counts)
    assert np.array_equal(enc, jrle.bytes_from_runs(jsyms, jcounts))
    s2, c2 = rle.runs_from_bytes(enc)
    js2, jc2 = jrle.runs_from_bytes(enc)
    assert np.array_equal(s2, js2) and np.array_equal(c2, jc2)
    assert np.array_equal(rle.decode_symbols(enc), jrle.decode_symbols(enc))
    assert np.array_equal(rle.decode_symbols(enc), dec)
    got, want = rle.rle_meta(enc, chunk=64), jrle.rle_meta(enc, chunk=64)
    assert got[0] == want[0] and got[2] == want[2]
    assert np.array_equal(got[1], want[1])


def test_npy_writer_golden_bytes(tmp_path):
    golden = open(GOLDEN_NPY, "rb").read()
    body = npy.load_bwt_bytes(GOLDEN_NPY)
    assert np.array_equal(body, jnpy.load_bwt_bytes(GOLDEN_NPY))
    out = tmp_path / "out.npy"
    npy.save_bwt_bytes(body, str(out))
    assert out.read_bytes() == golden
    syms, counts = rle.runs_from_bytes(body)
    npy.save_bwt_runs(syms, counts, str(out))
    assert out.read_bytes() == golden


@pytest.mark.parametrize("size", [1, 999, 123456])
def test_npy_matches_jax(tmp_path, size):
    body = np.random.default_rng(size).integers(0, 256, size).astype(np.uint8)
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    npy.save_bwt_bytes(body, str(a))
    jnpy.save_bwt_bytes(body, str(b))
    assert a.read_bytes() == b.read_bytes()
    assert np.array_equal(npy.load_bwt_bytes(str(a)), body)


def test_npy_rejects_short_body(tmp_path):
    bad = tmp_path / "bad.npy"
    bad.write_bytes(open(GOLDEN_NPY, "rb").read()[:-1])
    with pytest.raises(IOError):
        npy.load_bwt_bytes(str(bad))


@pytest.mark.parametrize("fmt", ["fasta", "fastq", "fastq.gz"])
def test_fastx_matches_jax(tmp_path, fmt):
    r = np.random.default_rng(7)
    alpha = np.frombuffer(b"ACGTNacgtuUxR-", np.uint8)
    seqs = [r.choice(alpha, r.integers(0, 60)).tobytes() for _ in range(30)]
    if fmt == "fasta":
        text = b"".join(b">r%d desc\n%s\n%s\n" % (i, s[:20], s[20:])
                        for i, s in enumerate(seqs))
    else:
        text = b"".join(b"@r%d\n%s\n+\n%s\n" % (i, s, b"F" * len(s))
                        for i, s in enumerate(seqs))
    path = tmp_path / f"reads.{fmt}"
    if fmt.endswith(".gz"):
        with gzip.open(path, "wb") as fp:
            fp.write(text)
    else:
        path.write_bytes(text)
    got = list(fastx.parse_fastx_records(str(path)))
    assert got == list(jfastx.parse_fastx_records(str(path)))
    got_native = native.parse_fastx_native(str(path))
    want_native = jnative.parse_fastx_native(str(path))
    assert [a.tolist() for a in got_native] == [b.tolist() for b in want_native]
    assert [a.tolist() for a in got_native] == [
        alphabet.convert_stoi(s).tolist() for _, s in got]


def test_checks_match_jax():
    bad_reads = np.array([[1, 0, 2]], np.uint8)
    for mod in (checks, jchecks):
        mod.set_debug(True)
    try:
        for fn, args in [
            ("validate_reads", (bad_reads, np.array([3], np.int32))),
            ("validate_bwt", (np.array([1, 9], np.uint8),)),
            ("validate_kmers", (np.array([[7]], np.uint8), None)),
        ]:
            with pytest.raises(ValueError):
                getattr(jchecks, fn)(*args)
            with pytest.raises(ValueError):
                getattr(checks, fn)(*args)
        checks.validate_reads(np.array([[1, 2, 0]], np.uint8), np.array([2], np.int32))
    finally:
        for mod in (checks, jchecks):
            mod.set_debug(False)


def test_native_host_kernels_match_jax():
    r = np.random.default_rng(11)
    reads = r.integers(0, 6, (500, 30)).astype(np.uint8)
    reads[:100] = reads[100:200]  # duplicate rows: the sort must be stable
    lengths = r.integers(0, 31, 500).astype(np.int32)
    order = native.sort_rows_native(reads)
    assert np.array_equal(order, jnative.sort_rows_native(reads))
    assert np.array_equal(native.reads_to_cols_native(reads, lengths, order),
                          jnative.reads_to_cols_native(reads, lengths, order))
    dec = _symbols(3000, 12, 30)
    enc = native.rle_encode_native(dec)
    assert np.array_equal(enc, jnative.rle_encode_native(dec))
    assert np.array_equal(native.rle_decode_native(enc), dec)
    reads_l = [r.integers(1, 6, r.integers(1, 20)).astype(np.uint8) for _ in range(30)]
    assert np.array_equal(native.baseline_build_native(reads_l),
                          jnative.baseline_build_native(reads_l))
    kmers = r.integers(0, 6, (40, 3)).astype(np.uint8)
    assert np.array_equal(native.baseline_count_kmers_native(enc, kmers),
                          jnative.baseline_count_kmers_native(enc, kmers))


def test_native_library_builds_in_port_dir():
    assert native.get_lib() is not None
    assert native._LIB.startswith(native._PKG)
    assert "rust_msbwt_tpu_torch" in native._LIB


_DOCTEST_MODULES = [
    "ops.rle", "ops.rank", "ops.packed_rank", "ops.bcr", "models.core",
    "models.dynamic", "models.rle_bwt", "utils.npy", "utils.fastx", "utils.checks",
    "ops.extract", "utils.streaming", "ops.pair_rank", "ops.run_rank",
    "utils.checkpoint", "apps.correct", "utils.oracle", "ops.merge",
    "parallel.sharded_merge", "parallel.doubling_merge", "parallel.sharded_build",
    "parallel.sharded_index", "parallel.partitioned", "parallel.multihost",
    "utils.profiling",
]


@pytest.mark.parametrize("name", _DOCTEST_MODULES)
def test_port_doctests(name):
    mod = importlib.import_module(f"rust_msbwt_tpu_torch.{name}")
    result = doctest.testmod(mod, raise_on_error=False)
    assert result.attempted > 0 and result.failed == 0


def test_golden_fasta_parses_like_jax():
    assert list(fastx.parse_fastx(GOLDEN_FA)) == list(jfastx.parse_fastx(GOLDEN_FA))
