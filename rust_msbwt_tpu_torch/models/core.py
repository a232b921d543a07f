"""L2 core — the shared BWT interface (port of the JAX package's
``models.core``: ``BWTRange`` and the ``count_kmer`` / ``count_kmers`` part
of ``BWTBase``).

Mirrors the reference's ``BWT`` trait (ref: src/msbwt_core.rs:28-161):
``get_symbol_count``, ``get_total_size``, ``constrain_range`` and the default
``count_kmer`` backward-search loop (early exit on an empty range at
:151-153). Also holds the host rank structure the engines' scalar queries
share.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.rank import BIN, PAD


@dataclasses.dataclass(frozen=True)
class BWTRange:
    """Half-open range [l, h) in the BWT (ref: src/msbwt_core.rs:19-24).

    >>> rng = BWTRange(2, 7)
    >>> rng.h - rng.l
    5
    """

    l: int = 0
    h: int = 0


class HostRank:
    """Occurrence checkpoints every ``BIN`` positions + the padded decoded
    symbols, on the host: the structure behind scalar ``constrain_range``.

    >>> hr = HostRank(np.array([5, 1, 2, 0, 3, 1, 5, 2, 3, 0], np.uint8))
    >>> hr.rank(1, 6), hr.rank(5, 10)
    (2, 2)
    """

    def __init__(self, decoded: np.ndarray):
        n = decoded.size
        nb = max(1, -(-n // BIN))
        self.padded = np.full(nb * BIN, PAD, dtype=np.uint8)
        self.padded[:n] = decoded
        per_bin = (
            self.padded.reshape(nb, BIN)[:, :, None]
            == np.arange(VC_LEN, dtype=np.uint8)[None, None, :]
        ).sum(axis=1)
        self.occ = np.vstack([np.zeros((1, VC_LEN), np.int64), np.cumsum(per_bin, 0)])

    def rank(self, sym: int, pos: int) -> int:
        """Occurrences of ``sym`` in ``bwt[0:pos]``."""
        b, r = divmod(int(pos), BIN)
        base = int(self.occ[b, sym])
        if r:
            base += int(np.count_nonzero(self.padded[b * BIN: b * BIN + r] == sym))
        return base


class BWTBase:
    """Shared query interface for the port's BWT types."""

    def get_symbol_count(self, symbol: int) -> int:
        raise NotImplementedError

    def get_total_size(self) -> int:
        raise NotImplementedError

    def constrain_range(self, sym: int, input_range: BWTRange) -> BWTRange:
        raise NotImplementedError

    def count_kmer(self, kmer) -> int:
        """Occurrences of an integer-encoded k-mer (ref: src/msbwt_core.rs:124-161).

        >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT(device="cpu")
        >>> bwt.insert_string("ACGT", True)
        >>> bwt.insert_string("TGCA", True)
        >>> bwt.count_kmer([1, 2, 3, 5])  # "ACGT"
        1
        >>> bwt.count_kmer([3, 2])  # "GC"
        1
        """
        kmer = np.asarray(kmer, dtype=np.uint8)
        if not np.all(kmer < VC_LEN):
            raise ValueError("k-mer symbols must be < 6")
        rng = BWTRange(0, self.get_total_size())
        for c in kmer[::-1]:
            if rng.h == rng.l:
                return 0
            rng = self.constrain_range(int(c), rng)
        return rng.h - rng.l

    def count_kmers(self, kmers, lengths=None) -> np.ndarray:
        """Batched ``count_kmer``: ``[B, K]`` right-aligned int k-mers -> ``[B]``.

        Default implementation loops on the host; the device-backed engines
        override it with the batched backward search.
        """
        kmers = np.asarray(kmers, dtype=np.uint8)
        if kmers.ndim == 1:
            kmers = kmers[None, :]
        B, K = kmers.shape
        if lengths is None:
            lengths = np.full(B, K, dtype=np.int32)
        out = np.zeros(B, dtype=np.uint64)
        for i in range(B):
            out[i] = self.count_kmer(kmers[i, K - int(lengths[i]):])
        return out
