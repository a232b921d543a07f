"""L0 — alphabet & encoding constants.

Behavioral contract mirrored from the reference (NOT a translation):
  * 6-symbol DNA alphabet ``$ A C G N T`` -> integers 0..5
    (ref: src/string_util.rs:6-9, src/string_util.rs:15-32; lower-case accepted,
    every other byte maps to N=4).
  * RLE bit-packing constants (ref: src/msbwt_core.rs:4-14).
  * ``COMPLEMENT_INT = [0,5,3,2,4,1]`` — $ and N self-complement
    (ref: src/string_util.rs:12).

Tables are plain numpy, used on the host; a copy of the JAX package's
``ops.alphabet`` (this package does not import that one, which pulls in jax).
"""

from __future__ import annotations

import numpy as np

# --- core constants (ref: src/msbwt_core.rs:4-14) ---
VC_LEN = 6          # $ A C G N T
LETTER_BITS = 3     # bits storing the character in an RLE byte
NUMBER_BITS = 5     # bits storing the count digit in an RLE byte
NUM_POWER = 32      # 2**NUMBER_BITS — base of multi-byte run counts
MASK = 0x07         # character mask
COUNT_MASK = 0x1F   # count-digit mask (after >> LETTER_BITS)

INT_TO_STRING = np.frombuffer(b"$ACGNT", dtype=np.uint8).copy()

COMPLEMENT_INT = np.array([0, 5, 3, 2, 4, 1], dtype=np.uint8)  # $ACGNT -> $TGCNA


def _build_stoi() -> np.ndarray:
    # everything unknown maps to N=4 (ref: src/string_util.rs:16)
    table = np.full(256, 4, dtype=np.uint8)
    for i, ch in enumerate(b"$ACGNT"):
        table[ch] = i
    for i, ch in enumerate(b"$acgnt"):
        table[ch] = i
    return table


STRING_TO_INT = _build_stoi()


def convert_stoi(seq) -> np.ndarray:
    """ASCII string/bytes -> int-encoded uint8 array (ref: src/string_util.rs:63-67).

    >>> convert_stoi("ACGNT$").tolist()
    [1, 2, 3, 4, 5, 0]
    >>> convert_stoi("acgt").tolist()  # lower-case accepted
    [1, 2, 3, 5]
    >>> convert_stoi("AxA").tolist()   # every other byte maps to N
    [1, 4, 1]
    """
    if isinstance(seq, str):
        seq = seq.encode("latin-1")
    raw = np.frombuffer(bytes(seq), dtype=np.uint8)
    return STRING_TO_INT[raw]


def convert_itos(iseq) -> str:
    """Int-encoded array -> ASCII string (ref: src/string_util.rs:80-88).

    >>> convert_itos([1, 2, 3, 4, 5, 0])
    'ACGNT$'
    """
    arr = np.asarray(iseq, dtype=np.uint8)
    return INT_TO_STRING[arr].tobytes().decode("latin-1")


def reverse_complement_i(seq) -> np.ndarray:
    """Reverse complement in integer space (ref: src/string_util.rs:45-50).

    >>> convert_itos(reverse_complement_i(convert_stoi("AACGT")))
    'ACGTT'
    >>> convert_itos(reverse_complement_i(convert_stoi("N$")))  # self-complement
    '$N'
    """
    arr = np.asarray(seq, dtype=np.uint8)
    return COMPLEMENT_INT[arr[::-1]]
