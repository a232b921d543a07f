"""The port's batch extensions, read correction, RLE host helpers and the
correct / convert / query command lines against the JAX package, on CPU.

The same seeded inputs (numpy) go through both packages; every comparison
is bit-exact (tolerance 0: every output is an integer, a byte string or a
line of text). Both packages' engines answer over the same BWT: the port
builds it, the JAX ``RleBWT`` loads its RLE bytes (no JAX build compiles).
"""

import numpy as np
import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.apps import correct as jcorrect
from rust_msbwt_tpu.cli.convert import main as jax_convert_main
from rust_msbwt_tpu.cli.correct import main as jax_correct_main
from rust_msbwt_tpu.cli.query import main as jax_query_main
from rust_msbwt_tpu.models.rle_bwt import RleBWT as JRleBWT
from rust_msbwt_tpu.ops import rle as jrle

from rust_msbwt_tpu_torch.apps import correct
from rust_msbwt_tpu_torch.cli.convert import main as convert_main
from rust_msbwt_tpu_torch.cli.correct import main as correct_main
from rust_msbwt_tpu_torch.cli.query import main as query_main
from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
from rust_msbwt_tpu_torch.ops import rle
from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi, reverse_complement_i
from rust_msbwt_tpu_torch.ops.bcr import build_msbwt

from tests._data import GOLDEN_NPY
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

_ALT = {1: 2, 2: 3, 3: 5, 5: 1}


def _engines(dec):
    payload = rle.encode_symbols(dec)
    port, ref = RleBWT(device="cpu"), JRleBWT()
    port.load_vector(payload)
    ref.load_vector(payload)
    return port, ref


@pytest.fixture(scope="module")
def corpus():
    """The correction corpus of ``tests/test_apps.py``: a 300 bp genome
    tiled by 60 bp reads at stride 2, each read twice (every k=21 window of
    an indexed read occurs >= 2 times), and 5 of those reads with one
    injected substitution each."""
    rng = np.random.default_rng(0xC0FFEE)
    genome = rng.integers(1, 6, 300).astype(np.uint8)
    genome[genome == 4] = 5  # no N, so substitutions are unambiguous
    L = 60
    starts = np.arange(0, genome.size - L + 1, 2)
    reads = np.repeat(np.stack([genome[s: s + L] for s in starts]), 2, axis=0)
    dec = build_msbwt(reads, np.full(reads.shape[0], L, np.int32), device="cpu")
    port, ref = _engines(dec)
    truth = reads[:5].copy()
    test_reads = truth.copy()
    err_pos = [10, 30, 45, 5, 55]
    for i, p in enumerate(err_pos):
        test_reads[i, p] = _ALT[int(truth[i, p])]
    return port, ref, dec, test_reads, truth, err_pos


def _kmers(dec, B, K, seed):
    """Right-aligned k-mers of ragged lengths, most of them from the BWT's
    own symbols (so most counts are non-zero)."""
    r = np.random.default_rng(seed)
    text = dec[dec != 0]
    st = r.integers(0, text.size - K, B)
    kmers = text[st[:, None] + np.arange(K)[None, :]].astype(np.uint8)
    kmers[-10:] = r.integers(0, 6, (10, K))
    lengths = r.integers(1, K + 1, B).astype(np.int32)
    kmers[np.arange(K)[None, :] < (K - lengths)[:, None]] = 0
    return kmers, lengths


# --- RLE host helpers ---


@pytest.mark.parametrize("stream", [
    "TAC$GATCG$", "GTN$$ACCC$G", "A" * 3104 + "\nC" * 3 + "A\nAAAA", b"", b"\n\n",
    "T" * 70000 + "$",
])
def test_rle_host_helpers_match_jax(stream):
    comp = rle.convert_to_vec(stream)
    jcomp = jrle.convert_to_vec(stream)
    assert comp.dtype == np.uint8 and np.array_equal(comp, jcomp)
    raw = np.frombuffer(stream.encode() if isinstance(stream, str) else stream, np.uint8)
    assert np.array_equal(rle.convert_to_vec(raw), jcomp)
    for got, want in zip(rle.runs_from_bytes_with_offsets(comp),
                         jrle.runs_from_bytes_with_offsets(jcomp)):
        assert got.dtype == want.dtype and np.array_equal(got, want)
    got, want = rle.symbol_counts_from_bytes(comp), jrle.symbol_counts_from_bytes(jcomp)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("stream", ["ACGX", "acgt", "AC GT"])
def test_convert_to_vec_rejects_bad_symbols(stream):
    with pytest.raises(ValueError, match="Unexpected symbol"):
        rle.convert_to_vec(stream)
    with pytest.raises(ValueError, match="Unexpected symbol"):
        jrle.convert_to_vec(stream)


# --- batch extensions of BWTBase ---


@pytest.mark.parametrize("k", [1, 5, 21])
def test_kmer_profile_matches_jax(corpus, k):
    port, ref, _, test_reads, truth, _ = corpus
    reads = np.vstack([test_reads, truth])
    got = port.kmer_profile(reads, k)
    assert got.shape == (10, 60 - k + 1)
    assert np.array_equal(got, ref.kmer_profile(reads, k))
    with pytest.raises(ValueError):
        port.kmer_profile(reads, 61)


def test_count_kmers_bidirectional_matches_jax(corpus):
    port, ref, dec, *_ = corpus
    kmers, lengths = _kmers(dec, 120, 9, 1)
    kmers[0, -6:] = convert_stoi("GCATGC")  # a reverse-complement palindrome
    lengths[0] = 6
    got = port.count_kmers_bidirectional(kmers, lengths)
    assert np.array_equal(got, ref.count_kmers_bidirectional(kmers, lengths))
    for i in range(0, 120, 7):
        q = kmers[i, 9 - lengths[i]:]
        assert got[i] == port.count_kmer(q) + port.count_kmer(reverse_complement_i(q))


@pytest.mark.parametrize("max_mismatch", [0, 1])
def test_count_kmers_approx_matches_jax(corpus, max_mismatch):
    port, ref, dec, *_ = corpus
    kmers, lengths = _kmers(dec, 60, 7, 2)
    got = port.count_kmers_approx(kmers, lengths, max_mismatch=max_mismatch)
    want = ref.count_kmers_approx(kmers, lengths, max_mismatch=max_mismatch)
    assert got.dtype == np.int64 and np.array_equal(got, want)
    if max_mismatch == 0:
        assert np.array_equal(got, port.count_kmers(kmers, lengths))
    with pytest.raises(NotImplementedError):
        port.count_kmers_approx(kmers, lengths, max_mismatch=2)


# --- read correction ---


@pytest.mark.parametrize("bidirectional", [True, False])
def test_flags_match_jax(corpus, bidirectional):
    port, ref, _, test_reads, truth, err_pos = corpus
    flags = correct.flag_read_errors(port, test_reads, k=21, tau=2,
                                     bidirectional=bidirectional)
    want = jcorrect.flag_read_errors(ref, test_reads, k=21, tau=2,
                                     bidirectional=bidirectional)
    assert np.array_equal(flags, want)
    for i, p in enumerate(err_pos):
        assert flags[i, p], f"read {i}: injected error at {p} not flagged"
    assert not correct.flag_read_errors(port, truth, k=21, tau=2).any()


@pytest.mark.parametrize("engine", ["rle", "dynamic"])
def test_correction_repairs_errors(corpus, engine):
    port, ref, dec, test_reads, truth, err_pos = corpus
    bwt = port if engine == "rle" else DynamicBWT.from_decoded(dec, device="cpu")
    fixed, n = correct.correct_reads(bwt, test_reads, k=21, tau=2)
    jfixed, jn = jcorrect.correct_reads(ref, test_reads, k=21, tau=2)
    assert n == jn and np.array_equal(fixed, jfixed)
    assert n >= len(err_pos)
    assert np.array_equal(fixed, truth)
    assert not correct.flag_read_errors(bwt, fixed, k=21, tau=2).any()


def test_score_candidates_match_jax(corpus):
    port, ref, _, test_reads, *_ = corpus
    ridx, pidx = np.nonzero(correct.flag_read_errors(port, test_reads, k=21, tau=2))
    for bidirectional in (True, False):
        got = correct._score_candidates(port, test_reads, ridx, pidx, 21, bidirectional)
        want = jcorrect._score_candidates(ref, test_reads, ridx, pidx, 21, bidirectional)
        assert np.array_equal(got, want)


@pytest.mark.parametrize("cap", [0, 1])
def test_correction_cap(corpus, cap):
    port, ref, _, test_reads, *_ = corpus
    fixed, n = correct.correct_reads(port, test_reads, k=21, tau=2,
                                     max_corrections_per_read=cap)
    jfixed, jn = jcorrect.correct_reads(ref, test_reads, k=21, tau=2,
                                        max_corrections_per_read=cap)
    assert n == jn and np.array_equal(fixed, jfixed)
    assert n <= cap * test_reads.shape[0]


@pytest.mark.parametrize("chunk", [1, 3])
def test_correction_chunked_scoring(corpus, chunk):
    port, _, _, test_reads, truth, _ = corpus
    fixed_a, n_a = correct.correct_reads(port, test_reads, k=21, tau=2)
    fixed_b, n_b = correct.correct_reads(port, test_reads, k=21, tau=2, suspect_chunk=chunk)
    assert n_a == n_b and np.array_equal(fixed_a, fixed_b)
    with pytest.raises(ValueError):
        correct.correct_reads(port, test_reads, k=21, tau=2, suspect_chunk=0)


def test_correction_edge_positions(corpus):
    """Errors at the first and last base (one covering window each)."""
    port, ref, _, _, truth, _ = corpus
    broken = truth[:2].copy()
    broken[0, 0] = _ALT[int(broken[0, 0])]
    broken[1, -1] = _ALT[int(broken[1, -1])]
    fixed, n = correct.correct_reads(port, broken, k=21, tau=2)
    jfixed, jn = jcorrect.correct_reads(ref, broken, k=21, tau=2)
    assert n == jn >= 2 and np.array_equal(fixed, jfixed)
    assert fixed[0, 0] == truth[0, 0] and fixed[1, -1] == truth[1, -1]


def test_correction_rejects_bad_reads(corpus):
    port = corpus[0]
    with pytest.raises(ValueError):
        correct.flag_read_errors(port, np.array([[1, 0, 2]], np.uint8), k=2)
    with pytest.raises(ValueError):
        correct.flag_read_errors(port, np.array([[1, 2, 2]], np.uint8), k=4)


# --- command lines ---


def _run_both(port_main, jax_main, argv_of, capsys):
    """Run the port's and the JAX package's CLI with the argument lists
    ``argv_of(tag)``; return ((rc, stdout) of the port, ... of JAX)."""
    out = []
    for tag, fn in (("port", port_main), ("jax", jax_main)):
        rc = fn(argv_of(tag))
        out.append((rc, capsys.readouterr().out))
    return out


def test_convert_cli_matches_jax(tmp_path, capsys):
    raw = tmp_path / "raw.txt"
    raw.write_text("TAC$GA\nTCG$\n")
    outs = {t: tmp_path / f"{t}.npy" for t in ("port", "jax")}
    (rc, _), (jrc, _) = _run_both(convert_main, jax_convert_main,
                                  lambda t: ["-i", str(raw), str(outs[t])], capsys)
    assert rc == jrc == 0
    assert outs["port"].read_bytes() == outs["jax"].read_bytes() == open(GOLDEN_NPY, "rb").read()


def test_convert_cli_stdin(tmp_path, monkeypatch):
    import io
    import sys

    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(b"TAC$GATCG$\n")))
    out = tmp_path / "out.npy"
    assert convert_main([str(out)]) == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


@pytest.mark.parametrize("case", ["bad_symbol", "missing_input", "unwritable"])
def test_convert_cli_exit_codes(tmp_path, capsys, case):
    raw = tmp_path / "raw.txt"
    raw.write_text("TAC$GXTCG$" if case == "bad_symbol" else "TAC$GATCG$")
    src = str(tmp_path / "nope.txt") if case == "missing_input" else str(raw)
    dst = str(tmp_path / "no" / "x.npy") if case == "unwritable" else str(tmp_path / "x.npy")
    (rc, _), (jrc, _) = _run_both(convert_main, jax_convert_main,
                                  lambda t: ["-i", src, dst], capsys)
    assert rc == jrc == {"bad_symbol": 74, "missing_input": 66, "unwritable": 74}[case]


@pytest.fixture()
def reads_fa(tmp_path):
    fa = tmp_path / "reads.fa"
    # ACGA: one substitution away from ACGT; CCCC has no 3-mer in the BWT;
    # GC is shorter than k and passes through
    fa.write_text(">r1 first\nACGA\n>r2\nTGCA\n>r3\nCCCC\n>r4\nGC\n")
    return str(fa)


@pytest.mark.parametrize("flags", [
    ["-k", "3", "--tau", "1"],
    ["-k", "3", "--tau", "1", "--single-strand"],
    ["-k", "3", "--tau", "1", "--max-corrections", "0", "--batch-size", "1"],
    ["-k", "2", "--tau", "2", "--cache-k", "2"],
    ["-k", "9"],
])
def test_correct_cli_matches_jax(tmp_path, capsys, reads_fa, flags):
    outs = {t: tmp_path / f"{t}.fa" for t in ("port", "jax")}

    def argv(tag):
        dev = ["--device", "cpu"] if tag == "port" else []
        return [*dev, *flags, "-o", str(outs[tag]), GOLDEN_NPY, reads_fa]

    (rc, _), (jrc, _) = _run_both(correct_main, jax_correct_main, argv, capsys)
    assert rc == jrc == 0
    assert outs["port"].read_text() == outs["jax"].read_text()
    if flags[:4] == ["-k", "3", "--tau", "1"] and len(flags) == 4:
        assert outs["port"].read_text().splitlines()[:2] == [">r1 first", "ACGT"]


def test_correct_cli_stdout(capsys, reads_fa):
    (rc, out), (jrc, jout) = _run_both(
        correct_main, jax_correct_main,
        lambda t: (["--device", "cpu"] if t == "port" else []) + ["-k", "3", "--tau", "1",
                                                                 GOLDEN_NPY, reads_fa],
        capsys)
    assert rc == jrc == 0 and out == jout and ">r4\nGC\n" in out


@pytest.mark.parametrize("case", ["no_bwt", "no_reads", "bad_k", "bad_batch",
                                  "bad_bwt", "bad_reads"])
def test_correct_cli_exit_codes(tmp_path, capsys, reads_fa, case):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"garbage")
    bwt, reads, extra = GOLDEN_NPY, reads_fa, []
    if case == "no_bwt":
        bwt = str(tmp_path / "nope.npy")
    elif case == "no_reads":
        reads = str(tmp_path / "nope.fa")
    elif case == "bad_k":
        extra = ["-k", "0"]
    elif case == "bad_batch":
        extra = ["--batch-size", "0"]
    elif case == "bad_bwt":
        bwt = str(bad)
    else:
        reads = str(bad)
    (rc, _), (jrc, _) = _run_both(
        correct_main, jax_correct_main,
        lambda t: (["--device", "cpu"] if t == "port" else []) + extra + [bwt, reads], capsys)
    want = {"no_bwt": 66, "no_reads": 66, "bad_k": 66, "bad_batch": 66,
            "bad_bwt": 74, "bad_reads": 74}[case]
    assert rc == jrc == want


def test_query_index_pack_save_then_load(tmp_path, capsys):
    kmers = ["ACGT", "TGCA", "$", "GC", "CG", "AAAA"]
    pack = tmp_path / "port.pack"
    jpack = tmp_path / "jax.pack"
    (rc, out), (jrc, jout) = _run_both(
        query_main, jax_query_main,
        lambda t: (["--device", "cpu", "--index-pack", str(pack)] if t == "port"
                   else ["--index-pack", str(jpack)]) + [GOLDEN_NPY, *kmers], capsys)
    assert rc == jrc == 0 and out == jout
    assert pack.is_file() and jpack.is_file()
    # second runs load the packs (each package's own, then each other's)
    for p in (pack, jpack):
        mtime = p.stat().st_mtime_ns
        assert query_main(["--device", "cpu", "--index-pack", str(p), GOLDEN_NPY, *kmers]) == 0
        assert capsys.readouterr().out == jout
        assert p.stat().st_mtime_ns == mtime  # loaded, not rewritten
        assert jax_query_main(["--index-pack", str(p), GOLDEN_NPY, *kmers]) == 0
        assert capsys.readouterr().out == jout
    # a new cache depth makes the pack stale: saved again, with the cache
    assert query_main(["--device", "cpu", "--cache-k", "2", "--index-pack", str(pack),
                       GOLDEN_NPY, *kmers]) == 0
    assert capsys.readouterr().out == jout
    with np.load(pack) as z:
        assert int(z["cache_k"]) == 2


@pytest.mark.parametrize("bad", ["garbage", "cut_zip", "missing_arrays"])
def test_query_bad_index_pack(tmp_path, capsys, bad):
    pack = tmp_path / "bad.pack"
    if bad == "garbage":
        pack.write_bytes(b"not a zip")
    elif bad == "cut_zip":
        with open(pack, "wb") as fh:
            np.savez(fh, a=np.arange(1000))
        pack.write_bytes(pack.read_bytes()[:100])
    else:
        with open(pack, "wb") as fh:
            np.savez(fh, a=np.arange(3))
    (rc, _), (jrc, _) = _run_both(
        query_main, jax_query_main,
        lambda t: (["--device", "cpu"] if t == "port" else []) + [
            "--index-pack", str(pack), GOLDEN_NPY, "ACGT"], capsys)
    assert rc == jrc == 74


def test_query_max_mismatch_matches_jax(tmp_path, capsys):
    kmers = tmp_path / "kmers.txt"
    kmers.write_text("ACGT\nACGA\nAC\nTTTT\nGCA\n$\nNNNN\n")
    for d in ("0", "1"):
        (rc, out), (jrc, jout) = _run_both(
            query_main, jax_query_main,
            lambda t: (["--device", "cpu"] if t == "port" else []) + [
                "--max-mismatch", d, GOLDEN_NPY, "-i", str(kmers)], capsys)
        assert rc == jrc == 0 and out == jout
    assert out.splitlines()[1] == "ACGA\t1"  # one substitution from ACGT
