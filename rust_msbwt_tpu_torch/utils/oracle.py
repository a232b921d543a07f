"""Test oracles: the naive MSBWT and pairwise Holt–McMillan merge (numpy).

The port's own copy of the JAX package's ``utils.oracle`` (the port imports
nothing of the JAX package). These are host-side references used by the
tests and doctests only — the oracle
pattern mirrors the reference's dominant test strategy (SURVEY.md §4):
every construction/query path is checked against ``naive_bwt``.

* ``naive_bwt`` sorts all rotations of each ``s + '$'``; strings are doubled
  so unequal lengths / cyclic ties break correctly
  (ref: src/bwt_util.rs:154-171, regression test src/bwt_util.rs:221-236).
* ``pairwise_bwt_merge`` is the Holt & McMillan 2014 interleave-refinement
  merge (ref: src/bwt_util.rs:21-141). It is NOT on any production path in
  the reference; here the production device version lives in ``ops.merge``
  and is validated against this one.
"""

from __future__ import annotations

import numpy as np


def naive_bwt(inputs: list[str]) -> str:
    """Ground-truth MSBWT by sorting doubled rotations (ref: src/bwt_util.rs:154-171).

    >>> naive_bwt(["ACG"])
    'G$AC'
    >>> naive_bwt(["ACGT", "TGCA"])
    'TAC$GATCG$'
    """
    rotations: list[str] = []
    for s in inputs:
        dollar = s + "$"
        for l in range(len(dollar)):
            rotations.append(dollar[l:] + dollar + dollar[:l])
    rotations.sort()
    return "".join(r[-1] for r in rotations)


def generate_offset_map(bwts: list) -> dict:
    """Char -> number of lexicographically smaller chars across all inputs
    (ref: src/bwt_util.rs:73-88)."""
    from collections import Counter

    counts: Counter = Counter()
    for bwt in bwts:
        counts.update(list(bwt))
    offsets = {}
    total = 0
    for ch in sorted(counts):
        offsets[ch] = total
        total += counts[ch]
    return offsets


def pairwise_merge_iter(interleave: np.ndarray, bwt0, bwt1, offsets: dict) -> np.ndarray:
    """One interleave-refinement round (ref: src/bwt_util.rs:21-55).

    ``interleave`` is a bool array; True means "take next from bwt0"
    (the reference's bit=1 case at src/bwt_util.rs:36-39).
    """
    next_interleave = np.zeros(interleave.size, dtype=bool)
    temp = dict(offsets)
    p0 = p1 = 0
    for b in interleave:
        if b:
            c = bwt0[p0]
            p0 += 1
        else:
            c = bwt1[p1]
            p1 += 1
        next_interleave[temp[c]] = b
        temp[c] += 1
    return next_interleave


def pairwise_bwt_merge(bwt0, bwt1):
    """Fixpoint Holt–McMillan merge of two BWTs (ref: src/bwt_util.rs:108-141).

    >>> "".join(pairwise_bwt_merge(naive_bwt(["ACGT"]), naive_bwt(["TGCA"])))
    'TAC$GATCG$'
    """
    bwt0 = list(bwt0)
    bwt1 = list(bwt1)
    total = len(bwt0) + len(bwt1)
    offsets = generate_offset_map([bwt0, bwt1])
    interleave = np.zeros(total, dtype=bool)
    final = np.zeros(total, dtype=bool)
    final[: len(bwt0)] = True
    while not np.array_equal(interleave, final):
        interleave = final
        final = pairwise_merge_iter(interleave, bwt0, bwt1, offsets)
    out = []
    p0 = p1 = 0
    for b in final:
        if b:
            out.append(bwt0[p0])
            p0 += 1
        else:
            out.append(bwt1[p1])
            p1 += 1
    return out
