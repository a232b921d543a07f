"""L1 — the RLE byte-stream codec (vectorized numpy, host-side).

The numpy half of the JAX package's ``ops.rle``, copied so that this package
never imports jax. Format contract (ref: src/bwt_converter.rs:53-56,163-168;
decoder semantics at src/rle_bwt.rs:360-371): each byte = ``symbol (low 3
bits) | count_digit << 3`` with ``count_digit in [0, 31]``. A run's count is
emitted as little-endian base-32 digits, one byte per digit, every byte
carrying the SAME symbol; a decoder treats consecutive same-symbol bytes as a
single run. Encoders assume no two consecutive runs share a symbol.

The device-side decode (``decode_symbols_device``) is not ported yet: the
port's ``RleBWT`` decodes on the host and uploads the symbols.
"""

from __future__ import annotations

import numpy as np

from rust_msbwt_tpu_torch.ops.alphabet import COUNT_MASK, LETTER_BITS, MASK, VC_LEN

_MAX_DIGITS = 13  # ceil(64 / 5): a u64 count has at most 13 base-32 digits


def runs_from_bytes(rle: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Decode RLE bytes into maximal runs ``(symbols u8[R], counts u64[R])``.

    >>> s, c = runs_from_bytes(np.array([1, 9, 25], np.uint8))
    >>> s.tolist(), c.tolist()
    ([1], [3104])
    """
    rle = np.asarray(rle, dtype=np.uint8)
    if rle.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.uint64)
    syms = rle & MASK
    digits = (rle >> LETTER_BITS).astype(np.uint64)
    is_start = np.empty(rle.size, dtype=bool)
    is_start[0] = True
    np.not_equal(syms[1:], syms[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    group_id = np.cumsum(is_start) - 1
    k = np.arange(rle.size, dtype=np.uint64) - starts[group_id].astype(np.uint64)
    contrib = digits << (np.uint64(5) * k)  # wraps mod 2**64 like the reference
    counts = np.add.reduceat(contrib, starts)
    return syms[starts], counts.astype(np.uint64)


def bytes_from_runs(syms: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Encode maximal runs into RLE bytes (ref: src/bwt_converter.rs:161-169).

    >>> bytes_from_runs([1], [3104]).tolist()  # 'A'x3104 -> digits 0,1,3
    [1, 9, 25]
    """
    syms = np.asarray(syms, dtype=np.uint8)
    counts = np.asarray(counts, dtype=np.uint64)
    if syms.size == 0:
        return np.zeros(0, dtype=np.uint8)
    if counts.min() < 1:
        raise ValueError("run counts must be >= 1")
    shifts = np.uint64(5) * np.arange(_MAX_DIGITS, dtype=np.uint64)
    shifted = counts[:, None] >> shifts[None, :]          # [R, 13]
    mask = shifted > 0                                    # monotone: keeps interior zero digits
    mask[:, 0] = True                                     # count>=1 always emits >=1 byte
    digit = (shifted & np.uint64(COUNT_MASK)).astype(np.uint8)
    byte = syms[:, None] | (digit << LETTER_BITS)
    return byte[mask]  # row-major flatten == little-endian digit order per run


def runs_from_symbols(decoded: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Extract maximal runs from a decoded symbol array.

    >>> syms, counts = runs_from_symbols([0, 1, 1, 1, 2])
    >>> syms.tolist(), counts.tolist()
    ([0, 1, 2], [1, 3, 1])
    """
    decoded = np.asarray(decoded, dtype=np.uint8)
    if decoded.size == 0:
        return np.zeros(0, dtype=np.uint8), np.zeros(0, dtype=np.uint64)
    is_start = np.empty(decoded.size, dtype=bool)
    is_start[0] = True
    np.not_equal(decoded[1:], decoded[:-1], out=is_start[1:])
    starts = np.flatnonzero(is_start)
    lengths = np.diff(np.append(starts, decoded.size)).astype(np.uint64)
    return decoded[starts], lengths


def decode_symbols(rle: np.ndarray) -> np.ndarray:
    """Fully decode RLE bytes into the flat symbol array (uint8).

    Uses the native host library when available (csrc/msbwt_host.cpp),
    falling back to the vectorized numpy path."""
    from rust_msbwt_tpu_torch.utils.native import rle_decode_native

    native = rle_decode_native(np.asarray(rle, dtype=np.uint8))
    if native is not None:
        return native
    syms, counts = runs_from_bytes(rle)
    return np.repeat(syms, counts.astype(np.int64))


def _run_aligned_bounds(rle: np.ndarray, chunk: int):
    """Yield ``(i, j)`` chunk bounds that never split a run."""
    i, total = 0, int(rle.size)
    while i < total:
        j = min(i + chunk, total)
        if j < total:
            s = rle[j - 1] & MASK
            while j < total and (rle[j] & MASK) == s:
                j += 1
        yield i, j
        i = j


def rle_meta(rle: np.ndarray, chunk: int = 1 << 22):
    """One CHUNKED pass over the compressed bytes: ``(n, symbol_counts, runs)``
    (the equivalent of ``calculate_totals``, ref: src/rle_bwt.rs:352-384);
    peak temporary memory is O(chunk).

    >>> n, counts, runs = rle_meta(np.array([13, 9, 10, 8], np.uint8))
    >>> n, counts.tolist(), runs
    (4, [1, 1, 1, 0, 0, 1], 4)
    """
    rle = np.asarray(rle, dtype=np.uint8)
    n = 0
    n_runs = 0
    counts = np.zeros(VC_LEN, dtype=np.uint64)
    for i, j in _run_aligned_bounds(rle, chunk):
        syms, rcounts = runs_from_bytes(rle[i:j])
        n += int(rcounts.sum())
        n_runs += int(syms.size)
        for s in range(VC_LEN):
            counts[s] += int(rcounts[syms == s].sum())
    return n, counts, n_runs
