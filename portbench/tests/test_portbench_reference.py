"""The plain reference against the port's CPU path at tiny sizes: one-shot
builds (ragged, duplicate and prefix reads, N calls, 1,000 bp reads at
radix 2) and appends onto a base (the append cell's shape), the BWT and
the packed table both."""

import numpy as np
import pytest
import torch

from portbench import check, data
from portbench.reference import msbwt as ref

from .conftest import SEED


def _port(parts, sorted_insert=True):
    """The port's CPU build of parts[0] and, when there are two, the
    append of parts[1] onto it."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index

    idx, packed = build_msbwt_with_index(*parts[0], device="cpu")
    if len(parts) == 2:
        reads, lengths = parts[0]
        idx, packed = build_msbwt_with_index(
            *parts[1], sorted_insert, base=idx.bwt[: idx.n], base_string_count=len(lengths),
            base_rot_max=int(lengths.max()) + 1, base_index=packed, device="cpu")
    return idx, packed


def _outputs(idx, packed):
    return {"bwt": idx.bwt, "table": packed.table, "occ": idx.occ, "starts": idx.starts,
            "packed_starts": packed.starts, "n": idx.n, "packed_n": packed.n}


def _ragged(rng, n, lmax, alphabet=(1, 2, 3, 4, 5)):
    lengths = rng.integers(1, lmax + 1, n).astype(np.int32)
    reads = np.zeros((n, lmax), np.uint8)
    for i, m in enumerate(lengths):
        reads[i, :m] = rng.choice(alphabet, m)
    return reads, lengths


def _cases():
    rng = np.random.default_rng(11)
    dup = rng.integers(1, 6, (6, 8)).astype(np.uint8)
    dup = np.concatenate([dup, dup[:3], dup[:2, :]])
    prefix = np.array([[1, 2, 3, 0], [1, 2, 3, 1], [1, 2, 0, 0], [1, 2, 3, 1]], np.uint8)
    cfg = {"genome_length": 3000, "genome_seed": 3, "read_length": 1000,
           "substitution_rate": 0.01, "n_rate": 0.0}
    long = data.reads_host(data.genome(cfg, "cpu"), cfg, 6, data.stream(SEED, "l"))
    sr = dict(cfg, read_length=100, substitution_rate=0.001, n_rate=0.01)
    codes = data.genome(sr, "cpu")
    base = data.reads_host(codes, sr, 120, data.stream(SEED, "b"))
    batch = data.reads_host(codes, sr, 15, data.stream(SEED, "c"))
    return {
        "ragged": [_ragged(rng, 30, 12)],
        "two_symbols": [_ragged(rng, 40, 6, (1, 2))],
        "duplicates": [(dup, np.full(len(dup), 8, np.int32))],
        "prefixes": [(prefix, np.array([3, 4, 2, 4], np.int32))],
        "long_reads_radix2": [long],
        "append": [base, batch],
        "append_ragged": [_ragged(rng, 25, 10), _ragged(rng, 9, 14, (1, 2, 3))],
        "append_repeats": [(dup, np.full(len(dup), 8, np.int32)), (dup[:4], np.full(4, 8, np.int32))],
    }


CASES = _cases()


@pytest.mark.parametrize("case", sorted(CASES))
def test_reference_equals_the_ports_cpu_path(case):
    parts = CASES[case]
    idx, packed = _port(parts)
    bwt = ref.msbwt(parts, "cpu")
    assert torch.equal(idx.bwt[: idx.n], bwt)
    assert torch.equal(packed.table[:, ref.OCC_LANES + ref.PLANE_LANES],
                       ref.packed_table(bwt)[:, ref.OCC_LANES + ref.PLANE_LANES])
    assert torch.equal(idx.starts, ref.starts_of(ref.packed_table(bwt)))
    assert check.compare(_outputs(idx, packed), parts, "cpu") == dict.fromkeys(check.LIMITS, 0)


def test_reference_on_the_two_string_example():
    """ACGT and TGCA give TAC$GATCG$ (the repo's golden file)."""
    reads = np.array([[1, 2, 3, 5], [5, 3, 2, 1]], np.uint8)
    bwt = ref.msbwt([(reads, np.array([4, 4], np.int32))], "cpu")
    assert bytes(np.frombuffer(b"$ACGNT", np.uint8)[bwt.numpy()]) == b"TAC$GATCG$"


@pytest.mark.parametrize("case", ["append", "append_ragged"])
def test_control_chronological_append_is_caught(case):
    """The control: the port's chronological insertion in place of its
    sorted one reads as differences."""
    parts = CASES[case]
    numbers = check.compare(_outputs(*_port(parts, sorted_insert=False)), parts, "cpu")
    assert numbers["bwt_mismatch"] > 0


def test_packed_table_layout():
    """Occurrences before each 128-symbol bin, three bit planes of four
    words, PAD past n, totals last."""
    rng = np.random.default_rng(2)
    bwt = torch.from_numpy(rng.integers(0, 6, 300).astype(np.uint8))
    t = ref.packed_table(bwt)
    assert t.shape == (4, 32)
    for b in range(3):
        for s in range(6):
            assert int(t[b, s]) == int((bwt[: 128 * b] == s).sum())
    padded = torch.full((384,), 7, dtype=torch.uint8)
    padded[:300] = bwt
    for b in range(3):
        for p in range(3):
            for j in range(4):
                word = sum(((int(padded[128 * b + 32 * j + k]) >> p) & 1) << k for k in range(32))
                assert int(t[b, 8 + 4 * p + j]) & 0xFFFFFFFF == word
    assert t[3, :6].tolist() == [int((bwt == s).sum()) for s in range(6)]
    assert t[:, 6:8].abs().sum() == 0 and t[:, 20:].abs().sum() == 0
