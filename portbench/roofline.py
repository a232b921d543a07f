"""The yardstick of the roofline metrics: the table of peaks and the bytes
each kernel's work needs.

Bytes count each input byte read once and each output byte written once,
for the op's own data: computed from the read set and the base alone,
never from the program's buffer capacities.
"""

from __future__ import annotations

import numpy as np

# published peaks by the name ``torch.cuda.get_device_name()`` gives: NVIDIA's
# H100 SXM data sheet, at its 700 W power limit
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12},
}


def hbm_bytes_per_s(device_name: str) -> float | None:
    peak = PEAKS.get(device_name)
    return peak["hbm_bytes_per_s"] if peak else None


def merge_pass_inserts(lengths: np.ndarray, pairs: int) -> list[int]:
    """Inserts of each merge pass of one build of reads of ``lengths``:
    stage 1 puts every read's last symbol (N), column j (2 <= j <= L + 1)
    inserts one symbol of every read of length >= j - 1; the first
    ``pairs`` passes after stage 1 take two columns each (radix 2), the
    rest one.

    >>> merge_pass_inserts(np.array([3, 1]), 0)   # stage 1, columns 2, 3, 4
    [2, 2, 1, 1]
    >>> merge_pass_inserts(np.array([3, 1]), 1)   # stage 1, columns 2-3, 4
    [2, 3, 1]
    """
    lengths = np.asarray(lengths, dtype=np.int64)
    L = int(lengths.max()) if lengths.size else 0
    # reads of length >= k for k = 1..L
    at_least = np.cumsum(np.bincount(lengths, minlength=L + 1)[::-1])[::-1][1:]
    cols = [int(c) for c in at_least]  # column j = k + 1
    if not 0 <= 2 * pairs <= len(cols):
        raise ValueError(f"{pairs} pairs over {len(cols)} columns")
    passes = [int(lengths.size)]
    passes += [cols[2 * p] + cols[2 * p + 1] for p in range(pairs)]
    passes += cols[2 * pairs:]
    return passes


def merge_pass_bytes(n0: int, lengths: np.ndarray, pairs: int) -> int:
    """Bytes the merge passes of one build need: a pass of k inserts that
    leaves n symbols reads the n - k old ones, writes the n new ones and
    the packed table (128 B a 128-symbol bin), and reads each insert's
    slot, symbol and flag (4 + 1 + 1 B): 3n + 6k, about.

    >>> merge_pass_bytes(10, np.array([3, 1]), 0)  # n after: 12, 14, 15, 16
    207
    >>> merge_pass_bytes(10, np.array([3, 1]), 1)  # n after: 12, 15, 16
    165
    """
    total, n = 0, int(n0)
    for k in merge_pass_inserts(lengths, pairs):
        n += k
        total += 3 * n + 6 * k
    return total
