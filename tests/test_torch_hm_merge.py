"""The port's ``ops.merge`` (H-M refinement, D-way doubling merge) and its
``utils.oracle`` against the JAX package's, on the same inputs made from a
numpy seed. Bit-exact throughout (tolerance 0: every output is an integer
or a bool): merged BWT bytes, source ids and interleave vectors."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (JAX on the CPU: tests/conftest.py)

from rust_msbwt_tpu.ops import merge as jmerge
from rust_msbwt_tpu.utils import oracle as joracle

from rust_msbwt_tpu_torch.ops import merge
from rust_msbwt_tpu_torch.ops.alphabet import convert_itos, convert_stoi
from rust_msbwt_tpu_torch.utils import oracle

from tests import _torch_cpu  # noqa: F401  (one torch thread a worker)


def _bwt(strings):
    return np.asarray(convert_stoi(oracle.naive_bwt(strings)), np.uint8)


def _strings(r, n, lmin=1, lmax=12, alpha="ACGNT"):
    return ["".join(r.choice(list(alpha), size=int(r.integers(lmin, lmax + 1))))
            for _ in range(n)]


def _groups(seed, d, per=(1, 5), lmax=12):
    r = np.random.default_rng(seed)
    return [_strings(r, int(r.integers(*per)), lmax=lmax) for _ in range(d)]


# ---------------------------------------------------------------------------
# the oracle copy
# ---------------------------------------------------------------------------

def test_oracle_matches_jax():
    r = np.random.default_rng(1)
    for _ in range(5):
        a, b = _strings(r, 4), _strings(r, 3)
        assert oracle.naive_bwt(a + b) == joracle.naive_bwt(a + b)
        ba, bb = oracle.naive_bwt(a), oracle.naive_bwt(b)
        assert oracle.generate_offset_map([ba, bb]) == joracle.generate_offset_map([ba, bb])
        inter = r.random(len(ba) + len(bb)) < 0.5
        offs = oracle.generate_offset_map([ba, bb])
        if inter.sum() == len(ba):  # a valid interleave: as many bwt0 picks as bwt0 symbols
            assert np.array_equal(oracle.pairwise_merge_iter(inter, ba, bb, offs),
                                  joracle.pairwise_merge_iter(inter, ba, bb, offs))
        assert oracle.pairwise_bwt_merge(ba, bb) == joracle.pairwise_bwt_merge(ba, bb)


def test_oracle_merge_iter_matches_jax():
    ba, bb = oracle.naive_bwt(["ACCA"]), oracle.naive_bwt(["CAAA"])
    offs = oracle.generate_offset_map([ba, bb])
    inter = np.zeros(len(ba) + len(bb), bool)
    inter[: len(ba)] = True
    assert np.array_equal(oracle.pairwise_merge_iter(inter, ba, bb, offs),
                          joracle.pairwise_merge_iter(inter, ba, bb, offs))


# ---------------------------------------------------------------------------
# pairwise H-M
# ---------------------------------------------------------------------------

PAIRS = {
    "paper": (["ACCA"], ["CAAA"]),
    "sizes": (["ACCA"], ["CA"]),
    "sizes_swapped": (["CA"], ["ACCA"]),
    "halves": (["CCGTACGTA", "GGTACAGTA"], ["ACGACGACG", "TTTT", "N"]),
    "similar": (["A", "AA", "AAA"], ["AAAA", "AAAAA"]),
    "random": tuple(_groups(11, 2, per=(2, 7))),
}


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_pairwise_matches_jax(name):
    left, right = PAIRS[name]
    a, b = _bwt(left), _bwt(right)
    got = merge.pairwise_bwt_merge(a, b, device="cpu")
    assert got.dtype == np.uint8
    assert np.array_equal(got, np.asarray(jmerge.pairwise_bwt_merge(a, b)))
    assert convert_itos(got) == oracle.naive_bwt(left + right)


@pytest.mark.parametrize("name", ["paper", "halves", "random"])
def test_merge_interleave_matches_jax(name):
    a, b = (_bwt(g) for g in PAIRS[name])
    got = merge.merge_interleave(a, b, device="cpu")
    assert got.dtype == np.bool_
    assert np.array_equal(got, np.asarray(jmerge.merge_interleave(a, b)))


def test_pairwise_rounds_and_tensor_io():
    """Tensor parts stay tensors on their device; ``stats`` counts rounds
    (the fixpoint's last round changes nothing)."""
    a, b = (_bwt(g) for g in PAIRS["halves"])
    st = {}
    got = merge.pairwise_bwt_merge(torch.from_numpy(a), torch.from_numpy(b), stats=st)
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert np.array_equal(got.numpy(), np.asarray(jmerge.pairwise_bwt_merge(a, b)))
    assert 2 <= st["rounds"] <= 11  # at most the longest rotation period + 1
    with pytest.raises(TypeError):
        merge.pairwise_bwt_merge(a, torch.from_numpy(b))


# ---------------------------------------------------------------------------
# D-way doubling
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed,d", [(21, 2), (22, 3), (23, 5), (24, 8)])
@pytest.mark.parametrize("sources", [False, True])
def test_multiway_matches_jax(seed, d, sources):
    parts = [_bwt(g) for g in _groups(seed, d)]
    got = merge.multiway_bwt_merge(parts, return_sources=sources, device="cpu")
    want = jmerge.multiway_bwt_merge(parts, return_sources=sources)
    if sources:
        assert got[1].dtype == np.int32
        assert np.array_equal(got[0], np.asarray(want[0]))
        assert np.array_equal(got[1], np.asarray(want[1]))
    else:
        assert np.array_equal(got, np.asarray(want))


def test_identical_reads_tie_order():
    """Identical reads across and within parts: ranks tie forever and the
    merge must keep source-major order, as the JAX package's does."""
    groups = [["AAAA", "AAAA"], ["AAAA"], ["ACGT", "AAAA", "AAAA"], ["ACGT"]]
    parts = [_bwt(g) for g in groups]
    got, src = merge.multiway_bwt_merge(parts, return_sources=True, device="cpu")
    want, wsrc = jmerge.multiway_bwt_merge(parts, return_sources=True)
    assert np.array_equal(got, np.asarray(want)) and np.array_equal(src, np.asarray(wsrc))
    assert np.array_equal(merge.pairwise_bwt_merge(parts[0], parts[1], device="cpu"),
                          np.asarray(jmerge.pairwise_bwt_merge(parts[0], parts[1])))
    assert np.array_equal(merge.merge_interleave(parts[0], parts[2], device="cpu"),
                          np.asarray(jmerge.merge_interleave(parts[0], parts[2])))


def test_long_reads_match_jax():
    """Rotation periods of 200 and more: H-M takes a round per symbol of
    depth, the doubling merge a handful."""
    r = np.random.default_rng(31)
    groups = [_strings(r, 2, 200, 260, "ACGT") for _ in range(3)]
    parts = [_bwt(g) for g in groups]
    st = {}
    got = merge.multiway_bwt_merge(parts, device="cpu", stats=st)
    assert np.array_equal(got, np.asarray(jmerge.multiway_bwt_merge(parts)))
    assert st["rounds"] <= 11
    st = {}
    pair = merge.pairwise_bwt_merge(parts[0], parts[1], device="cpu", stats=st)
    assert np.array_equal(pair, np.asarray(jmerge.pairwise_bwt_merge(parts[0], parts[1])))
    assert st["rounds"] > 11
    assert convert_itos(got) == oracle.naive_bwt([s for g in groups for s in g])


@pytest.mark.parametrize("mode", ["doubling", "tree"])
def test_kway_matches_jax(mode, monkeypatch):
    parts = [_bwt(g) for g in _groups(41, 5)]
    if mode == "tree":
        monkeypatch.setenv("MSBWT_TPU_MERGE", "tree")
    st = {}
    got = merge.kway_merge(parts, device="cpu", stats=st)
    assert np.array_equal(got, np.asarray(jmerge.kway_merge(parts)))
    if mode == "tree":
        assert st["merges"] == 4
    monkeypatch.delenv("MSBWT_TPU_MERGE", raising=False)
    assert np.array_equal(got, merge.multiway_bwt_merge(parts, device="cpu"))


@pytest.mark.parametrize("fn", ["pairwise", "interleave", "multiway", "kway_tree"])
def test_force_wide_matches_jax(fn, monkeypatch):
    """int64 ("wide") positions — the > 2^31 path — on small data: the
    same bytes as the JAX package's narrow and wide results."""
    parts = [_bwt(g) for g in _groups(51, 3, per=(3, 5), lmax=9)]
    if fn == "pairwise":
        got = merge.pairwise_bwt_merge(parts[0], parts[1], force_wide=True, device="cpu")
        want = jmerge.pairwise_bwt_merge(parts[0], parts[1])
    elif fn == "interleave":
        got = merge.merge_interleave(parts[0], parts[1], force_wide=True, device="cpu")
        want = jmerge.merge_interleave(parts[0], parts[1], force_wide=True)
    elif fn == "multiway":
        got = merge.multiway_bwt_merge(parts, force_wide=True, return_sources=True,
                                       device="cpu")
        want = jmerge.multiway_bwt_merge(parts, force_wide=True, return_sources=True)
        assert np.array_equal(got[1], np.asarray(want[1]))
        got, want = got[0], want[0]
    else:
        monkeypatch.setenv("MSBWT_TPU_MERGE", "tree")
        got = merge.kway_merge(parts, force_wide=True, device="cpu")
        want = jmerge.kway_merge(parts)
    assert np.array_equal(got, np.asarray(want))


def test_empty_and_single_parts():
    one = _bwt(["GATTACA"])
    empty = np.zeros(0, np.uint8)
    assert np.array_equal(merge.pairwise_bwt_merge(empty, one, device="cpu"),
                          np.asarray(jmerge.pairwise_bwt_merge(empty, one)))
    assert np.array_equal(merge.pairwise_bwt_merge(one, empty, device="cpu"), one)
    # an empty side: the JAX package's interleave gathers from an empty
    # array and raises; the port's is the trivial interleave
    with pytest.raises(TypeError):
        jmerge.merge_interleave(empty, one)
    assert not merge.merge_interleave(empty, one, device="cpu").any()
    assert merge.merge_interleave(one, empty, device="cpu").all()
    for parts in ([one], [empty, one], [one, empty, empty]):
        got, src = merge.multiway_bwt_merge(parts, return_sources=True, device="cpu")
        want, wsrc = jmerge.multiway_bwt_merge(parts, return_sources=True)
        assert np.array_equal(got, np.asarray(want)) and np.array_equal(src, np.asarray(wsrc))
    got, src = merge.multiway_bwt_merge([], return_sources=True, device="cpu")
    assert got.size == 0 and src.dtype == np.int32
    assert merge.kway_merge([], device="cpu").size == 0
    assert merge.kway_merge([empty, empty], device="cpu").size == 0


def test_sources_rebuild_the_interleave():
    """Pairwise: the doubling merge's source ids are the H-M interleave."""
    a, b = (_bwt(g) for g in PAIRS["random"])
    _, src = merge.multiway_bwt_merge([a, b], return_sources=True, device="cpu")
    assert np.array_equal(src == 0, merge.merge_interleave(a, b, device="cpu"))
