"""Inputs drawn from a configuration and a seed: the same seed gives the
same inputs, another seed others; the genome belongs to the configuration
and not to the seed."""

import numpy as np
import pytest
import torch

from portbench import data
from portbench.run import find_cell

from .conftest import SEED

CFG = {"genome_length": 4000, "genome_seed": 7, "read_length": 50,
       "substitution_rate": 0.01, "n_rate": 0.001}


def test_genome_is_fixed_by_the_config():
    a, b = data.genome(CFG, "cpu"), data.genome(CFG, "cpu")
    assert torch.equal(a, b) and a.numel() == 4000 and int(a.max()) <= 3
    assert not torch.equal(a, data.genome(dict(CFG, genome_seed=8), "cpu"))


@pytest.mark.parametrize("other", [SEED + 1, 1, 0])
def test_reads_follow_the_seed(other):
    codes = data.genome(CFG, "cpu")
    a, la = data.reads_host(codes, CFG, 300, data.stream(SEED, "set", 0))
    b, _ = data.reads_host(codes, CFG, 300, data.stream(SEED, "set", 0))
    c, _ = data.reads_host(codes, CFG, 300, data.stream(other, "set", 0))
    assert a.shape == (300, 50) and a.dtype == np.uint8 and (la == 50).all()
    assert np.array_equal(a, b) and not np.array_equal(a, c)
    assert set(np.unique(a)) <= {1, 2, 3, 4, 5}


def test_reads_are_genome_windows_with_the_stated_errors():
    """Without errors each read is a window of the genome or its reverse
    complement; with them about the stated share of bases differs."""
    codes = data.genome(CFG, "cpu")
    sym = np.array([1, 2, 3, 5], np.uint8)[codes.numpy()]
    comp = np.array([0, 5, 3, 2, 4, 1], np.uint8)
    clean = dict(CFG, substitution_rate=0.0, n_rate=0.0)
    r, _ = data.reads_host(codes, clean, 200, data.stream(SEED, "x"))
    text, rc = sym.tobytes(), comp[sym[::-1]].tobytes()
    assert all(row.tobytes() in text or row.tobytes() in rc for row in r)
    noisy = dict(CFG, substitution_rate=0.2, n_rate=0.05, read_length=200)
    r, _ = data.reads_host(codes, noisy, 2000, data.stream(SEED, "y"))
    assert 0.03 < (r == 4).mean() < 0.07


def test_traffic_draws_from_the_seed(tiny):
    """The append mix's batches and its checked op are the same for one
    seed and differ for another; the build mix's read sets likewise. Both
    are drawn in set-up and taken in turn."""
    bench, root = tiny
    cell = find_cell("tiny-sr.tappend", bench, root)

    def session(seed):
        return cell.generator.Session(cell.config, cell.mix, seed, "cpu")

    a, b, c = session(SEED), session(SEED), session(SEED + 1)
    for i in (0, 5):
        assert np.array_equal(a._inputs(i)[0], b._inputs(i)[0])
        assert not np.array_equal(a._inputs(i)[0], c._inputs(i)[0])
    assert not np.array_equal(a._inputs(0)[0], a._inputs(1)[0])
    assert len(a.sets) == cell.generator.BATCHES == 32
    assert a._inputs(3)[0] is a._inputs(3 + len(a.sets))[0]
    assert np.array_equal(a.base_parts[0][0], b.base_parts[0][0])
    assert not np.array_equal(a.base_parts[0][0], c.base_parts[0][0])
    assert a.drawn == b.drawn and 0 <= a.drawn < len(a.sets)
    cell = find_cell("tiny-lr.build", bench, root)
    s1 = cell.generator.Session(cell.config, cell.mix, SEED, "cpu")
    s2 = cell.generator.Session(cell.config, cell.mix, SEED + 1, "cpu")
    assert len(s1.sets) == cell.generator.READ_SETS == 2
    assert not np.array_equal(s1.sets[0][0], s1.sets[1][0])
    assert not np.array_equal(s1.sets[0][0], s2.sets[0][0])
