"""L2a — the static RLE BWT query engine (port of the JAX package's
``models.rle_bwt``).

Load-then-query engine with the observable behavior of the reference's
``RleBWT`` (ref: src/rle_bwt.rs): loads the ``comp_msbwt.npy`` RLE byte
vector, computes symbol totals in one chunked pass, and answers
``constrain_range`` / ``count_kmer`` on the host and batched ``count_kmers``
on the device.

The device index is decoded on the HOST (native RLE decode) and uploaded;
the JAX package's device-side decode is not ported yet. Batched queries use
the packed tier at every size: the pair tier the JAX package switches to at
32M symbols is not ported yet, and the packed tier gives identical counts.
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.models.core import BWTBase, BWTRange, HostRank
from rust_msbwt_tpu_torch.ops import rank as rank_ops
from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed, pack_index
from rust_msbwt_tpu_torch.ops.rle import decode_symbols, rle_meta
from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes


class RleBWT(BWTBase):
    """Static query engine over a compressed BWT (ref: src/rle_bwt.rs:14-24).

    >>> bwt = RleBWT(device="cpu")
    >>> bwt.load_vector([13, 9, 10, 8, 11, 9, 13, 10, 11, 8])  # {ACGT, TGCA}
    >>> bwt.get_total_size()
    10
    >>> bwt.count_kmer([1, 2, 3, 5])  # "ACGT"
    1
    >>> bwt.constrain_range(5, BWTRange(0, 10))  # rows prefixed "T"
    BWTRange(l=8, h=10)
    >>> bwt.count_kmers(np.array([[1, 2, 3, 5], [0, 0, 3, 2]]), [4, 2]).tolist()
    [1, 1]
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self.bwt = np.zeros(0, dtype=np.uint8)  # RLE bytes
        self._standard_init()

    # --- loading (ref: src/rle_bwt.rs:59-155,324-348) ---

    def load_vector(self, bwt) -> None:
        self.bwt = np.asarray(bwt, dtype=np.uint8)
        self._standard_init()

    def load_numpy_file(self, filename: str) -> None:
        self.bwt = load_bwt_bytes(filename)
        self._standard_init()

    def _standard_init(self) -> None:
        """One chunked pass over the compressed bytes (``calculate_totals``,
        ref: src/rle_bwt.rs:352-384); every index is derived lazily and
        every index of a previously loaded BWT is dropped."""
        n, counts, _ = rle_meta(self.bwt)
        self.total_size = n
        self.symbol_counts = counts.astype(np.uint64)
        self.start_index = np.cumsum(self.symbol_counts) - self.symbol_counts
        self._host_rank: HostRank | None = None
        self._device_index: rank_ops.OccIndex | None = None
        self._packed_index = None
        self._kmer_cache = None
        self._cache_k = 0

    # --- queries ---

    def get_symbol_count(self, symbol: int) -> int:
        return int(self.symbol_counts[symbol])

    def get_total_size(self) -> int:
        return self.total_size

    def constrain_range(self, sym: int, input_range: BWTRange) -> BWTRange:
        """Result-equivalent to the reference's RLE-decoding scan
        (ref: src/rle_bwt.rs:202-287), over host occ checkpoints."""
        if self._host_rank is None:
            self._host_rank = HostRank(decode_symbols(self.bwt))
        c = int(self.start_index[sym])
        return BWTRange(
            l=c + self._host_rank.rank(sym, input_range.l),
            h=c + self._host_rank.rank(sym, input_range.h),
        )

    @property
    def device_index(self) -> rank_ops.OccIndex:
        """Occurrence index on the device (decoded on the host, uploaded)."""
        if self._device_index is None:
            self._device_index = rank_ops.build_occ_index(
                decode_symbols(self.bwt), self.total_size, device=self.device
            )
        return self._device_index

    @property
    def packed_index(self):
        """Packed single-gather rank index (``ops.packed_rank``)."""
        if self._packed_index is None:
            self._packed_index = pack_index(self.device_index)
        return self._packed_index

    def enable_kmer_cache(self, cache_k: int = 8) -> None:
        """Precompute the ranges of all length-``cache_k`` strings
        (``cache_k`` <= 8) so batched queries skip their first ``cache_k``
        LF steps (the reference's unshipped cache idea, ref:
        src/msbwt_core.rs:133-146)."""
        idx = self.device_index
        self._kmer_cache = rank_ops.build_kmer_cache(
            idx.bwt, idx.occ, idx.starts, idx.n, cache_k
        )
        self._cache_k = cache_k

    def count_kmers(self, kmers, lengths=None) -> np.ndarray:
        """Batched counts of right-aligned k-mers on the device.

        Uses the packed tier at every size: the JAX package's pair tier
        (taken at 32M symbols and more) is not ported yet, and the packed
        tier gives identical counts at every size."""
        return count_kmers_packed(
            self.packed_index, kmers, lengths,
            cache=self._kmer_cache, cache_k=self._cache_k,
        )

