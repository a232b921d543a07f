"""The port's build and query command lines on CPU (``--device cpu``),
against the reference golden file and the JAX package's CLIs."""

import gzip

import pytest

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.cli.build import main as jax_build_main
from rust_msbwt_tpu.cli.query import main as jax_query_main

from rust_msbwt_tpu_torch.cli.build import main as build_main
from rust_msbwt_tpu_torch.cli.query import main as query_main

from tests._data import GOLDEN_FA, GOLDEN_NPY


def test_build_golden_byte_identity(tmp_path):
    out = tmp_path / "out.npy"
    assert build_main(["--device", "cpu", "-o", str(out), GOLDEN_FA]) == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


def test_build_stdout(capsys):
    assert build_main(["--device", "cpu", GOLDEN_FA]) == 0
    assert capsys.readouterr().out.strip() == "TAC$GATCG$"


def test_build_fastq_gzip(tmp_path):
    fq = tmp_path / "reads.fq.gz"
    with gzip.open(fq, "wb") as fp:
        fp.write(b"@r1\nACGT\n+\nFFFF\n@r2\nTGCA\n+\nFFFF\n")
    out = tmp_path / "out.npy"
    assert build_main(["--device", "cpu", "-o", str(out), str(fq)]) == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


@pytest.mark.parametrize("unsorted", [False, True])
def test_build_matches_jax_cli(tmp_path, unsorted):
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(
        ["GATTACA", "ACGTTGCA", "TTTT", "ACGT", "NNACGTN", "GATTACA", "C"])))
    flags = ["--unsorted"] if unsorted else []
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    assert build_main(["--device", "cpu", *flags, "-o", str(a), str(fa)]) == 0
    assert jax_build_main([*flags, "-o", str(b), str(fa)]) == 0
    assert a.read_bytes() == b.read_bytes()


def test_build_missing_input(tmp_path):
    assert build_main(["--device", "cpu", "-o", str(tmp_path / "x.npy"),
                       "/nonexistent.fa"]) == 66


def test_build_cannot_create_output(tmp_path):
    assert build_main(["--device", "cpu", "-o", str(tmp_path / "no" / "x.npy"),
                       GOLDEN_FA]) == 73


def test_build_bad_input_is_ioerr(tmp_path):
    bad = tmp_path / "bad.fa"
    bad.write_text("not a fastx file\n")
    assert build_main(["--device", "cpu", "-o", str(tmp_path / "x.npy"), str(bad)]) == 74


def test_build_runtime_error_is_not_ioerr(tmp_path, monkeypatch):
    # only parse errors (OSError / ValueError) map to 74; a device or kernel
    # failure propagates with its traceback, so the process exits 1, not 74
    from rust_msbwt_tpu_torch.models import dynamic

    def fail(*args, **kwargs):
        raise RuntimeError("merge kernel failed")

    monkeypatch.setattr(dynamic, "create_from_fastx", fail)
    with pytest.raises(RuntimeError, match="merge kernel failed"):
        build_main(["--device", "cpu", "-o", str(tmp_path / "x.npy"), GOLDEN_FA])


def test_query_counts(capsys):
    assert query_main(["--device", "cpu", GOLDEN_NPY, "ACGT", "TGCA", "$", "GC", "AAAA"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines == ["ACGT\t1", "TGCA\t1", "$\t2", "GC\t1", "AAAA\t0"]


def test_query_matches_jax_cli(tmp_path, capsys):
    kmers = tmp_path / "kmers.txt"
    kmers.write_text("AC\nCG\nGT\nT\nACGT$\nCA\n")
    assert query_main(["--device", "cpu", "--cache-k", "2", GOLDEN_NPY, "-i",
                       str(kmers)]) == 0
    got = capsys.readouterr().out
    assert jax_query_main([GOLDEN_NPY, "-i", str(kmers)]) == 0
    assert got == capsys.readouterr().out


def test_query_exit_codes(tmp_path):
    assert query_main(["--device", "cpu", "/nonexistent.npy", "ACGT"]) == 66
    assert query_main(["--device", "cpu", GOLDEN_NPY]) == 66  # no k-mers
    bad = tmp_path / "bad.npy"
    bad.write_bytes(b"garbage")
    assert query_main(["--device", "cpu", str(bad), "ACGT"]) == 74
