"""L1 — the ``comp_msbwt.npy`` numpy container contract (a copy of the JAX
package's ``utils.npy``; this package does not import that one).

Writer contract (byte-identical to the reference, verified against the hex of
``test_data/two_string.npy``; ref: src/bwt_converter.rs:102-130,151-184):
exactly 96 header bytes = magic ``\\x93NUMPY\\x01\\x00`` + header-len
``\\x56\\x00`` (86 LE) + the dict string
``{'descr': '|u1', 'fortran_order': False, 'shape': (N, ), }`` — note the
space inside ``, )``, a deliberate reference quirk (src/bwt_converter.rs:120)
— padded with 0x20 to byte 94, ``\\n`` at byte 95, then the raw RLE bytes.

Reader contract (more general than the writer; ref: src/rle_bwt.rs:81-155):
honors arbitrary header lengths with 16-byte-aligned padding, parses the
header dict, and errors if ``shape[0]`` differs from the remaining file size.
"""

from __future__ import annotations

import ast
import os

import numpy as np

_MAGIC = b"\x93NUMPY\x01\x00\x56\x00"
_HEADER_BODY = b"{'descr': '|u1', 'fortran_order': False, 'shape': ("
_HEADER_TAIL = b", ), }"


def save_bwt_bytes(rle_bytes: np.ndarray, filename: str) -> None:
    """Save RLE bytes to the exact reference npy layout
    (ref: src/bwt_converter.rs:102-130).

    The header is always exactly 96 bytes, so file size = 96 + body:

    >>> import tempfile, os
    >>> path = os.path.join(tempfile.mkdtemp(), "comp_msbwt.npy")
    >>> save_bwt_bytes(np.array([13, 9], dtype=np.uint8), path)
    >>> os.path.getsize(path)
    98
    >>> load_bwt_bytes(path).tolist()
    [13, 9]
    """
    rle_bytes = np.asarray(rle_bytes, dtype=np.uint8)
    header = _MAGIC + _HEADER_BODY + str(rle_bytes.size).encode() + _HEADER_TAIL
    if len(header) > 95:
        raise ValueError("npy header overflow — shape digits exceed fixed header")
    header = header + b" " * (95 - len(header)) + b"\n"
    with open(filename, "wb") as fp:
        fp.write(header)
        fp.write(rle_bytes.tobytes())


def save_bwt_runs(syms: np.ndarray, counts: np.ndarray, filename: str) -> None:
    """Save a run list to npy, compressing runs to RLE bytes first
    (equivalent of ``save_bwt_runs_numpy``, ref: src/bwt_converter.rs:151-184)."""
    from rust_msbwt_tpu_torch.ops.rle import bytes_from_runs

    save_bwt_bytes(bytes_from_runs(syms, counts), filename)


def load_bwt_bytes(filename: str) -> np.ndarray:
    """Load the RLE byte body from a compressed-BWT npy file
    (ref: src/rle_bwt.rs:81-155 — identical copy at src/dynamic_bwt.rs:133-207)."""
    full_file_size = os.path.getsize(filename)
    with open(filename, "rb") as fp:
        init_header = fp.read(10)
        if len(init_header) != 10:
            raise IOError(
                f"Could not read initial 10 bytes of header for file {filename!r}"
            )
        header_len = init_header[8] + 256 * init_header[9]
        skip_bytes = 10 + header_len
        if skip_bytes % 16 != 0:
            skip_bytes = (skip_bytes // 16 + 1) * 16
        rest_header = fp.read(skip_bytes - 10)
        if len(rest_header) != skip_bytes - 10:
            raise IOError(
                f"Could not read bytes 10-{skip_bytes} of header for file {filename!r}"
            )
        header_dict = _parse_header_dict(rest_header)
        expected_length = int(header_dict["shape"][0])
        bwt_disk_size = full_file_size - skip_bytes
        if expected_length != bwt_disk_size:
            raise IOError(
                f"Header indicates shape of {expected_length}, but remaining "
                f"file size is {bwt_disk_size}"
            )
        # readinto a preallocated array: fp.read() + frombuffer().copy()
        # would hold TWO npy-sized host buffers at peak
        body = np.empty(bwt_disk_size, dtype=np.uint8)
        got = fp.readinto(memoryview(body))
        if got != bwt_disk_size:
            raise IOError(
                f"Only read {got} of {bwt_disk_size} bytes of BWT body "
                f"for file {filename!r}"
            )
    return body


def _parse_header_dict(raw: bytes) -> dict:
    text = raw.decode("latin-1").rstrip()
    try:
        return ast.literal_eval(text)
    except (SyntaxError, ValueError) as exc:
        raise IOError(f"Error while parsing header string: {text!r}") from exc
