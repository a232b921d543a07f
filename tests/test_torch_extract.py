"""The port's read recovery (``ops.extract``: ``extract_reads``,
``locate_kmers``) and its command lines (``msbwt2-extract``,
``msbwt2-query --locate``) against the JAX package, on CPU. Every
comparison is bit-exact (tolerance 0): read bytes, read ids, offsets.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.cli.extract import main as jax_extract_main
from rust_msbwt_tpu.cli.query import main as jax_query_main
from rust_msbwt_tpu.models.rle_bwt import RleBWT as JRleBWT
from rust_msbwt_tpu.ops import extract as jextract
from rust_msbwt_tpu.ops.rank import build_occ_index as j_build_occ_index

from rust_msbwt_tpu_torch.cli.extract import main as extract_main
from rust_msbwt_tpu_torch.cli.query import main as query_main
from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
from rust_msbwt_tpu_torch.ops import bcr, extract
from rust_msbwt_tpu_torch.ops.alphabet import convert_itos
from rust_msbwt_tpu_torch.ops.rle import bytes_from_runs, runs_from_symbols
from rust_msbwt_tpu_torch.utils.npy import save_bwt_runs

from tests._data import GOLDEN_NPY
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


@pytest.fixture(scope="module")
def archive():
    """60 ragged reads over ACGT (so no k-mer with an N occurs; with
    duplicates and tandem repeats), their sorted BWT, and both packages'
    indexes of it."""
    r = np.random.default_rng(17)
    acgt = np.array([1, 2, 3, 5], np.uint8)
    reads_l = [acgt[r.integers(0, 4, r.integers(1, 30))] for _ in range(50)]
    reads_l += reads_l[:5] + [np.tile(np.array([1, 2], np.uint8), 7)[:n] for n in (3, 8, 13, 14, 4)]
    bwt = bcr.build_msbwt(*bcr.encode_reads(reads_l), device="cpu")
    idx = bcr.index_from_symbols(torch.from_numpy(bwt))
    order = sorted(range(len(reads_l)), key=lambda i: convert_itos(reads_l[i]))
    return {"reads": reads_l, "sorted": [reads_l[i] for i in order], "bwt": bwt,
            "idx": idx, "jidx": j_build_occ_index(bwt), "n": len(reads_l)}


def _same_reads(a, b):
    return len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))


def test_extract_all_reads_matches_jax(archive):
    idx, packed = archive["idx"]
    ids = np.arange(archive["n"])
    got = extract.extract_reads(idx, ids, archive["n"], packed=packed)
    assert _same_reads(got, jextract.extract_reads(archive["jidx"], ids, archive["n"]))
    assert _same_reads(got, archive["sorted"])


def test_extract_subset_duplicates_and_bad_ids(archive):
    idx, packed = archive["idx"]
    n = archive["n"]
    ids = [7, 3, 3, n - 1, 0]
    got = extract.extract_reads(idx, ids, n, packed=packed)
    assert _same_reads(got, jextract.extract_reads(archive["jidx"], ids, n))
    assert _same_reads(got, [archive["sorted"][i] for i in ids])
    assert extract.extract_reads(idx, [], n) == []
    for bad in ([n], [-1]):
        with pytest.raises(ValueError):
            extract.extract_reads(idx, bad, n, packed=packed)
    with pytest.raises(ValueError):  # the walk bound is too short
        extract.extract_reads(idx, ids, n, l_max=2, packed=packed)


def test_locate_kmers_matches_jax(archive):
    idx, packed = archive["idx"]
    n = archive["n"]
    # hits (taken from the reads, some from the duplicated ones), no hits
    # (a 'N' never occurs), and a short k-mer with many hits
    kmers = [archive["reads"][i][:4] for i in (0, 1, 50, 2) if archive["reads"][i].size >= 4]
    kmers += [np.array([4, 4, 4, 4], np.uint8), np.array([0, 0, 1, 2], np.uint8)]
    kmers = np.stack(kmers)
    lengths = np.array([4] * (len(kmers) - 1) + [2], np.int32)
    got = extract.locate_kmers(idx, kmers, n, lengths=lengths, packed=packed)
    want = jextract.locate_kmers(archive["jidx"], kmers, n, lengths=lengths)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    q, rid, off = got
    counts = np.bincount(q, minlength=len(kmers))
    assert counts[len(kmers) - 2] == 0 and counts.max() > 1
    for qi, ri, oi in zip(q, rid, off):  # every hit is where it says
        k = kmers[qi][kmers.shape[1] - lengths[qi]:]
        assert np.array_equal(archive["sorted"][ri][oi: oi + k.size], k)
    none = extract.locate_kmers(idx, np.array([[4, 4, 4]], np.uint8), n, packed=packed)
    assert all(a.size == 0 for a in none)
    with pytest.raises(ValueError):
        extract.locate_kmers(idx, np.array([[6]], np.uint8), n)


def test_locate_kmers_model_methods_match_jax(archive):
    kmers = np.stack([archive["reads"][i][:3] for i in range(20)
                      if archive["reads"][i].size >= 3])
    rle = bytes_from_runs(*runs_from_symbols(archive["bwt"]))
    port, ref = RleBWT(device="cpu"), JRleBWT()
    port.load_vector(rle)
    ref.load_vector(rle)
    want = ref.locate_kmers(kmers)
    for got in (port.locate_kmers(kmers),
                _dynamic(archive["reads"]).locate_kmers(kmers)):
        for g, w in zip(got, want):
            assert np.array_equal(g, w)


def _dynamic(reads_l):
    bwt = DynamicBWT(device="cpu")
    bwt.insert_strings(reads_l[:30], True)
    bwt.to_vec()
    bwt.insert_strings(reads_l[30:], True)  # an extended BWT locates the same
    return bwt


def test_extract_cli_matches_jax_cli(archive, tmp_path, capsys):
    path = str(tmp_path / "comp_msbwt.npy")
    save_bwt_runs(*runs_from_symbols(archive["bwt"]), path)
    for args in ([], ["3", "10-12", "0"]):
        assert extract_main(["--device", "cpu", path, *args]) == 0
        got = capsys.readouterr().out
        assert jax_extract_main([path, *args]) == 0
        assert got == capsys.readouterr().out
    assert got.splitlines()[1] == convert_itos(archive["sorted"][3])
    assert extract_main(["--device", "cpu", path, str(archive["n"])]) == 66
    assert extract_main(["--device", "cpu", path, "x-y"]) == 66
    assert extract_main(["--device", "cpu", str(tmp_path / "missing.npy")]) == 66


def test_extract_cli_golden(capsys):
    assert extract_main(["--device", "cpu", GOLDEN_NPY]) == 0
    assert capsys.readouterr().out == ">read_0\nACGT\n>read_1\nTGCA\n"


def test_query_locate_matches_jax_cli(archive, tmp_path, capsys):
    path = str(tmp_path / "comp_msbwt.npy")
    save_bwt_runs(*runs_from_symbols(archive["bwt"]), path)
    kmers = [convert_itos(archive["reads"][i][:3]) for i in range(8)
             if archive["reads"][i].size >= 3] + ["NNN", "AC"]
    assert query_main(["--device", "cpu", "--locate", path, *kmers]) == 0
    got = capsys.readouterr().out
    assert jax_query_main(["--locate", path, *kmers]) == 0
    assert got == capsys.readouterr().out
    assert len(got.splitlines()) > len(kmers)  # count lines + hit lines
    assert query_main(["--device", "cpu", "--locate", GOLDEN_NPY, "CG"]) == 0
    assert capsys.readouterr().out == "CG\t1\nCG\t0\t1\n"
