"""L2 core — the shared BWT interface (port of the JAX package's
``models.core``).

Mirrors the reference's ``BWT`` trait (ref: src/msbwt_core.rs:28-161):
``get_symbol_count``, ``get_total_size``, ``constrain_range`` and the default
``count_kmer`` backward-search loop (early exit on an empty range at
:151-153), plus the batch extensions every engine gets on top of its
``count_kmers``: ``kmer_profile``, ``count_kmers_bidirectional`` and
``count_kmers_approx``. Also holds the host rank structure the engines'
scalar queries share.
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

    def kmer_profile(self, reads, k: int) -> np.ndarray:
        """Counts of every length-``k`` window of each read: ``[B, L]`` int
        reads -> ``[B, L - k + 1]`` counts, as one batched ``count_kmers``
        (the error-correction primitive of the original msbwt).

        >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT(device="cpu")
        >>> bwt.insert_strings(["ACGT", "TGCA"], sorted=True)
        >>> bwt.kmer_profile(np.array([[1, 2, 3, 5]]), 2).tolist()  # AC CG GT
        [[1, 1, 1]]
        """
        reads = np.asarray(reads, dtype=np.uint8)
        if reads.ndim == 1:
            reads = reads[None, :]
        B, L = reads.shape
        if not 1 <= k <= L:
            raise ValueError(f"k={k} out of range for reads of length {L}")
        w = L - k + 1
        windows = np.lib.stride_tricks.sliding_window_view(reads, k, axis=1)
        return self.count_kmers(windows.reshape(B * w, k)).reshape(B, w)

    def count_kmers_bidirectional(self, kmers, lengths=None) -> np.ndarray:
        """Forward + reverse-complement counts per k-mer (the double-stranded
        convention of fmlrc-style correction; a palindrome counts twice).

        >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT(device="cpu")
        >>> bwt.insert_strings(["ACGT", "TGCA"], sorted=True)
        >>> bwt.count_kmers_bidirectional(np.array([[3, 2]])).tolist()  # GC
        [2]
        """
        from rust_msbwt_tpu_torch.ops.alphabet import COMPLEMENT_INT

        kmers = np.asarray(kmers, dtype=np.uint8)
        if kmers.ndim == 1:
            kmers = kmers[None, :]
        B, K = kmers.shape
        if lengths is None:
            lengths = np.full(B, K, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        comp = COMPLEMENT_INT[kmers]
        # reverse each row's right-aligned window, keeping right alignment
        j = np.arange(K, dtype=np.int64)[None, :]
        src = 2 * K - lengths[:, None] - 1 - j
        valid = j >= (K - lengths[:, None])
        rc = np.where(valid, np.take_along_axis(comp, np.clip(src, 0, K - 1), axis=1),
                      0).astype(np.uint8)
        counts = self.count_kmers(np.vstack([kmers, rc]), np.concatenate([lengths, lengths]))
        return counts[:B] + counts[B:]

    def count_kmers_approx(self, kmers, lengths=None, max_mismatch: int = 1) -> np.ndarray:
        """Occurrences within Hamming distance ``max_mismatch`` (0 or 1): the
        exact count plus the exact counts of every single substitution over
        A C G N T, in one more batched ``count_kmers`` (each text window
        matches exactly one variant, so the sum is exact).

        >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
        >>> bwt = DynamicBWT(device="cpu")
        >>> bwt.insert_strings(["ACGT", "AGGT"], sorted=True)
        >>> int(bwt.count_kmers_approx(np.array([[1, 2, 3]]))[0])  # "ACG" +-1
        2
        """
        kmers = np.asarray(kmers, dtype=np.uint8)
        if kmers.ndim == 1:
            kmers = kmers[None, :]
        B, K = kmers.shape
        if lengths is None:
            lengths = np.full(B, K, dtype=np.int32)
        lengths = np.asarray(lengths, dtype=np.int32)
        exact = np.asarray(self.count_kmers(kmers, lengths), dtype=np.int64)
        if max_mismatch == 0:
            return exact
        if max_mismatch != 1:
            raise NotImplementedError("max_mismatch must be 0 or 1")
        active = np.arange(K)[None, :] >= (K - lengths[:, None])   # [B, K]
        cand = np.arange(1, VC_LEN, dtype=np.uint8)[None, None, :]
        ok = active[:, :, None] & (cand != kmers[:, :, None])      # [B, K, 5]
        b_idx, p_idx, c_idx = np.nonzero(ok)
        if b_idx.size == 0:
            return exact
        variants = kmers[b_idx].copy()
        variants[np.arange(b_idx.size), p_idx] = (c_idx + 1).astype(np.uint8)
        vcounts = np.asarray(self.count_kmers(variants, lengths[b_idx]), dtype=np.int64)
        out = exact.copy()
        np.add.at(out, b_idx, vcounts)
        return out

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
