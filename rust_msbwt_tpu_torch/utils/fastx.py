"""FASTA/FASTQ ingestion (gzip supported; a copy of the JAX package's
``utils.fastx``) — the needletail role in the
reference (ref: src/dynamic_bwt.rs:453-473 uses ``parse_fastx_file`` +
``Sequence::normalize(false)``).

Normalization contract (matching needletail's ``normalize(iupac=false)``):
uppercase; RNA ``U``/``u`` -> ``T``; ``ACGT`` kept; every other byte -> ``N``.
Format is sniffed from content like needletail: gzip magic first, then
``>`` == FASTA / ``@`` == FASTQ.
"""

from __future__ import annotations

import gzip
from typing import Iterator

import numpy as np

# byte -> normalized byte (needletail normalize(false) semantics)
_NORMALIZE = np.full(256, ord("N"), dtype=np.uint8)
for _ch in b"ACGT":
    _NORMALIZE[_ch] = _ch
    _NORMALIZE[_ch + 32] = _ch  # lowercase
_NORMALIZE[ord("U")] = ord("T")
_NORMALIZE[ord("u")] = ord("T")


def normalize_seq(seq: bytes) -> bytes:
    """Needletail ``normalize(iupac=false)`` semantics.

    >>> normalize_seq(b"acgu-N")
    b'ACGTNN'
    """
    return _NORMALIZE[np.frombuffer(seq, dtype=np.uint8)].tobytes()


def _open_maybe_gzip(filename: str):
    with open(filename, "rb") as probe:
        magic = probe.read(2)
    if magic == b"\x1f\x8b":
        return gzip.open(filename, "rb")
    return open(filename, "rb")


def parse_fastx(filename: str) -> Iterator[bytes]:
    """Yield normalized sequences from a FASTA or FASTQ file (plain or gzip)."""
    for _name, seq in parse_fastx_records(filename):
        yield seq


def parse_fastx_records(filename: str) -> Iterator[tuple[bytes, bytes]]:
    """Yield ``(name, normalized_sequence)`` pairs from a FASTA or FASTQ
    file (plain or gzip). ``name`` is the raw header line minus the
    leading ``>``/``@`` marker (full description, not just the first
    token) — record-identity-preserving tools (read correction, mate
    pairing) need it surfaced, not dropped.

    >>> import tempfile, os
    >>> path = tempfile.mktemp(suffix=".fa")
    >>> _ = open(path, "w").write(">r1 sample\\nACGT\\n>r2\\nttgg\\n")
    >>> [(n, s) for n, s in parse_fastx_records(path)]
    [(b'r1 sample', b'ACGT'), (b'r2', b'TTGG')]
    >>> os.unlink(path)
    """
    fp = _open_maybe_gzip(filename)
    try:
        first = fp.readline()
        if not first:
            return
        if first.startswith(b">"):
            yield from _parse_fasta(fp, first)
        elif first.startswith(b"@"):
            yield from _parse_fastq(fp, first)
        else:
            raise ValueError(
                f"{filename}: not a FASTA/FASTQ file (starts with {first[:1]!r})"
            )
    finally:
        fp.close()


def _parse_fasta(fp, first_header: bytes) -> Iterator[tuple[bytes, bytes]]:
    # every '>' closes the previous record (empty records are records too)
    name = first_header.rstrip(b"\r\n")[1:]
    chunks: list[bytes] = []
    for line in fp:
        line = line.rstrip(b"\r\n")
        if line.startswith(b">"):
            yield name, normalize_seq(b"".join(chunks))
            name = line[1:]
            chunks = []
        elif line:
            chunks.append(line)
    yield name, normalize_seq(b"".join(chunks))


def _parse_fastq(fp, first_header: bytes) -> Iterator[tuple[bytes, bytes]]:
    header = first_header
    while header:
        seq = fp.readline().rstrip(b"\r\n")
        plus = fp.readline()
        qual = fp.readline()
        if not plus.startswith(b"+") or not qual:
            raise ValueError("truncated FASTQ record")
        yield header.rstrip(b"\r\n")[1:], normalize_seq(seq)
        header = fp.readline()
