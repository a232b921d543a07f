"""Debug-mode validation of build and query inputs.

The validators of the JAX package's ``utils.checks`` that the build and
query path call. Enable with ``MSBWT_TPU_DEBUG=1`` (or ``set_debug(True)``);
in release mode they are no-ops, mirroring the reference's release-profile
behavior.
"""

from __future__ import annotations

import os

import numpy as np

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN

_DEBUG = bool(os.environ.get("MSBWT_TPU_DEBUG"))


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = bool(on)


def validate_kmers(kmers: np.ndarray, lengths: np.ndarray | None) -> None:
    """Shape/dtype/alphabet guard for query batches (debug mode only).

    >>> set_debug(True)
    >>> validate_kmers(np.array([[1, 2, 3]], np.uint8), None)  # fine
    >>> validate_kmers(np.array([[9]], np.uint8), None)
    Traceback (most recent call last):
        ...
    ValueError: kmer symbols must be < 6
    >>> set_debug(False)
    >>> validate_kmers(np.array([[9]], np.uint8), None)  # release: no-op
    """
    if not _DEBUG:
        return
    kmers = np.asarray(kmers)
    if kmers.dtype != np.uint8:
        raise TypeError(f"kmers must be uint8, got {kmers.dtype}")
    if kmers.size and kmers.max() >= VC_LEN:
        raise ValueError("kmer symbols must be < 6")
    if lengths is not None:
        lengths = np.asarray(lengths)
        if lengths.min() < 0 or (kmers.ndim == 2 and lengths.max() > kmers.shape[1]):
            raise ValueError("kmer lengths out of range")


def validate_reads(reads: np.ndarray, lengths: np.ndarray) -> None:
    if not _DEBUG:
        return
    reads = np.asarray(reads)
    lengths = np.asarray(lengths)
    if reads.ndim != 2 or reads.dtype != np.uint8:
        raise TypeError("reads must be a [N, L] uint8 matrix")
    if reads.size and reads.max() >= VC_LEN:
        raise ValueError("read symbols must be < 6")
    if lengths.shape[0] != reads.shape[0]:
        raise ValueError("lengths/reads shape mismatch")
    if lengths.size and lengths.max() > reads.shape[1]:
        raise ValueError("length exceeds read matrix width")
    # interior '$' breaks rotation-order semantics (see ops.bcr docstring)
    cols = np.arange(reads.shape[1])[None, :]
    in_read = cols < lengths[:, None]
    if np.any((reads == 0) & in_read):
        raise ValueError("reads must not contain interior '$' (symbol 0)")


def validate_bwt(decoded: np.ndarray) -> None:
    if not _DEBUG:
        return
    decoded = np.asarray(decoded)
    if decoded.dtype != np.uint8 or (decoded.size and decoded.max() >= VC_LEN):
        raise ValueError("decoded BWT must be uint8 symbols < 6")
