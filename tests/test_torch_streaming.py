"""The port's streamed builds (``utils.streaming``, ``msbwt2-build
--batch-size``) against one-shot builds and the JAX package, on CPU.

Sorted streaming equals one sorted build (order independence); chronological
streaming equals one chronological build. Checkpoints are the JAX package's
bytes, and a JAX checkpoint resumes in the port exactly as in JAX. Every
comparison is bit-exact (tolerance 0).
"""

import json

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.cli.build import main as jax_build_main
from rust_msbwt_tpu.ops import bcr as jbcr
from rust_msbwt_tpu.utils.streaming import StreamingBuilder as JStreamingBuilder

from rust_msbwt_tpu_torch.cli.build import main as build_main
from rust_msbwt_tpu_torch.models.dynamic import create_from_fastx_streaming
from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder, build_msbwt_streaming

from tests._data import GOLDEN_FA, GOLDEN_NPY
from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)

L = 20  # one read-matrix width for the whole file (JAX compiles per shape)


def _batch(n, seed):
    r = np.random.default_rng(seed)
    reads_l = [r.integers(1, 6, r.integers(1, L + 1)).astype(np.uint8) for _ in range(n)]
    reads, lengths = bcr.encode_reads(reads_l)
    out = np.zeros((n, L), np.uint8)
    out[:, : reads.shape[1]] = reads
    return out, lengths


@pytest.mark.parametrize("sorted_insert", [True, False])
@pytest.mark.parametrize("batch_size", [1, 7, 30])
def test_streaming_equals_one_shot(sorted_insert, batch_size):
    reads, lengths = _batch(30, seed=1)
    want = bcr.build_msbwt(reads, lengths, sorted_insert, device="cpu")
    got = build_msbwt_streaming(reads, lengths, batch_size, sorted_insert, device="cpu")
    assert np.array_equal(got, want)


def test_streaming_variable_batch_shapes():
    b = StreamingBuilder(device="cpu")
    parts = []
    for seed, n in [(2, 5), (3, 11), (4, 1), (5, 8)]:
        reads, lengths = bcr.encode_reads(  # ragged widths: every batch its own L
            [np.random.default_rng(seed + i).integers(1, 6, seed + i).astype(np.uint8)
             for i in range(n)])
        parts.append((reads, lengths))
        b.add_batch(reads, lengths)
    assert b.string_count == 25
    all_reads = [r[:n] for reads, lens in parts for r, n in zip(reads, lens)]
    want = bcr.build_msbwt(*bcr.encode_reads(all_reads), device="cpu")
    assert np.array_equal(b.finish(), want)
    assert torch.equal(b.finish(device_out=True), torch.from_numpy(want))


def test_streaming_empty(tmp_path):
    b = StreamingBuilder(device="cpu")
    b.add_batch(np.zeros((0, 4), np.uint8), np.zeros(0, np.int32))
    assert b.string_count == 0 and b.finish().size == 0
    assert create_from_fastx_streaming([], device="cpu").to_vec().size == 0
    # an empty checkpoint round-trips, and bytes match the JAX package's
    b.checkpoint(str(tmp_path / "a.npy"))
    JStreamingBuilder().checkpoint(str(tmp_path / "b.npy"))
    assert (tmp_path / "a.npy").read_bytes() == (tmp_path / "b.npy").read_bytes()
    assert StreamingBuilder.restore(str(tmp_path / "a.npy"), device="cpu").finish().size == 0


def test_empty_fastx_file_gives_empty_bwt(tmp_path):
    # edge difference: the JAX package's native parser fails on a file with
    # no records (NULL buffers); the port reads it as zero reads
    from rust_msbwt_tpu.utils.native import parse_fastx_native as j_parse

    empty = tmp_path / "empty.fa"
    empty.write_text("")
    assert create_from_fastx_streaming([str(empty)], device="cpu").to_vec().size == 0
    with pytest.raises(ValueError):
        j_parse(str(empty))


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_checkpoint_bytes_match_jax(tmp_path, sorted_insert):
    batches = [_batch(9, seed=s) for s in (11, 12)]
    port, ref = StreamingBuilder(sorted_insert, device="cpu"), JStreamingBuilder(sorted_insert)
    for reads, lengths in batches:
        port.add_batch(reads, lengths)
        ref.add_batch(reads, lengths)
    assert np.array_equal(port.finish(), ref.finish())
    a, b = str(tmp_path / "port.npy"), str(tmp_path / "jax.npy")
    port.checkpoint(a)
    ref.checkpoint(b)
    assert open(a, "rb").read() == open(b, "rb").read()
    assert open(a + ".meta.json").read() == open(b + ".meta.json").read()


@pytest.mark.parametrize("sorted_insert", [True, False])
def test_jax_checkpoint_resumes_in_port(tmp_path, sorted_insert):
    path = str(tmp_path / "ck.npy")
    first, rest = _batch(9, seed=21), [_batch(9, seed=22), _batch(9, seed=23)]
    ref = JStreamingBuilder(sorted_insert)
    ref.add_batch(*first)
    ref.checkpoint(path)
    port = StreamingBuilder.restore(path, device="cpu")
    ref = JStreamingBuilder.restore(path)
    assert port.sorted_insert == sorted_insert
    assert port.string_count == ref.string_count == 9
    for reads, lengths in rest:
        port.add_batch(reads, lengths)
        ref.add_batch(reads, lengths)
        assert np.array_equal(port.finish(), ref.finish())
    # and the port's own checkpoint resumes into the uninterrupted result
    port.checkpoint(path)
    again = StreamingBuilder.restore(path, device="cpu")
    assert json.load(open(path + ".meta.json"))["string_count"] == 27
    whole = [first] + rest
    reads = np.concatenate([r for r, _ in whole])
    lengths = np.concatenate([ln for _, ln in whole])
    want = bcr.build_msbwt(reads, lengths, sorted_insert, device="cpu")
    assert np.array_equal(again.finish(), want)
    assert np.array_equal(want, np.asarray(jbcr.build_msbwt(reads, lengths, sorted_insert)))


def test_build_cli_batch_size_golden(tmp_path):
    out = tmp_path / "out.npy"
    assert build_main(["--device", "cpu", "--batch-size", "1", "-o", str(out),
                       GOLDEN_FA]) == 0
    assert out.read_bytes() == open(GOLDEN_NPY, "rb").read()


@pytest.mark.parametrize("unsorted", [False, True])
def test_build_cli_batch_size_matches_jax_cli(tmp_path, unsorted):
    fa = tmp_path / "reads.fa"
    fa.write_text("".join(f">r{i}\n{s}\n" for i, s in enumerate(
        ["GATTACA", "ACGTTGCA", "TTTT", "ACGT", "NNACGTN", "GATTACA", "C", "ACAC"])))
    flags = ["--batch-size", "3"] + (["--unsorted"] if unsorted else [])
    a, b = tmp_path / "a.npy", tmp_path / "b.npy"
    assert build_main(["--device", "cpu", *flags, "-o", str(a), str(fa)]) == 0
    assert jax_build_main([*flags, "-o", str(b), str(fa)]) == 0
    assert a.read_bytes() == b.read_bytes()
