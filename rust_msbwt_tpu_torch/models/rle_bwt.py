"""L2a — the static RLE BWT query engine (port of the JAX package's
``models.rle_bwt``).

Load-then-query engine with the observable behavior of the reference's
``RleBWT`` (ref: src/rle_bwt.rs): loads the ``comp_msbwt.npy`` RLE byte
vector, computes symbol totals in one chunked pass, and answers
``constrain_range`` / ``count_kmer`` on the host, and batched
``count_kmers`` / ``locate_kmers`` on the device. It also keeps the
reference's run-boundary-sampled parity FM tables (``fm_index`` /
``ref_index``, ref: src/rle_bwt.rs:387-467), built lazily.

The device index is decoded ON the device (``ops.rle.decode_symbols_device``:
the upload carries the compressed bytes), and the occurrence and packed
indexes come from one no-insert merge pass (``ops.bcr.index_from_symbols``).
``count_kmers`` picks its tier as the JAX package does: the packed tier
below ``PAIR_AUTO_MIN_SYMBOLS``, the pair index plus a 6^``CACHE_AUTO_K``
prefix cache above, and the run-compressed tier when the decoded tiers
would not fit ``DEVICE_BUDGET_GB``. The switches ``MSBWT_TPU_NO_PAIR``,
``MSBWT_TPU_NO_CACHE``, ``MSBWT_TPU_RUN_TIER`` and
``MSBWT_TPU_DEVICE_BUDGET_GB`` act as they do there.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from rust_msbwt_tpu_torch.models.core import BWTBase, BWTRange, HostRank
from rust_msbwt_tpu_torch.ops import rank as rank_ops
from rust_msbwt_tpu_torch.ops import run_rank
from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.bcr import index_from_symbols
from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
from rust_msbwt_tpu_torch.ops.rle import (
    decode_symbols,
    decode_symbols_device,
    rle_meta,
    runs_from_bytes_with_offsets,
)
from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes


def build_sampled_fm_index(rle_bytes: np.ndarray,
                           bin_power: int) -> tuple[np.ndarray, np.ndarray]:
    """The reference's sampled FM tables from RLE bytes: ``(ref_index [L],
    fm_index [VC_LEN, L])`` (``construct_fmindex``, ref:
    src/rle_bwt.rs:387-467). For bin boundary ``p = i * 2^bin_power``, the
    first run whose end exceeds ``p``: its byte offset and the occurrences
    of each symbol before it; the last entry holds the totals and the byte
    length.

    >>> ref, fm = build_sampled_fm_index(np.array([13, 9, 10, 8], np.uint8), 1)
    >>> ref.tolist(), fm[:, -1].tolist()
    ([0, 2, 4], [1, 1, 1, 0, 0, 1])
    """
    syms, counts, byte_starts = runs_from_bytes_with_offsets(rle_bytes)
    counts = counts.astype(np.int64)
    total = int(counts.sum())
    bin_size = 1 << bin_power
    index_length = -(-total // bin_size) + 1 if total else 1
    ref_index = np.zeros(index_length, dtype=np.uint64)
    fm_index = np.zeros((VC_LEN, index_length), dtype=np.uint64)
    if total == 0:
        return ref_index, fm_index
    run_ends = np.cumsum(counts)
    one_hot = syms[:, None] == np.arange(VC_LEN, dtype=np.uint8)[None, :]
    occ_incl = np.cumsum(one_hot * counts[:, None], axis=0)          # [R, 6]
    occ_before = np.vstack([np.zeros((1, VC_LEN), np.int64), occ_incl[:-1]])
    boundaries = np.arange(index_length - 1, dtype=np.int64) * bin_size
    run_idx = np.searchsorted(run_ends, boundaries, side="right")
    ref_index[:-1] = byte_starts[run_idx].astype(np.uint64)
    fm_index[:, :-1] = occ_before[run_idx].T.astype(np.uint64)
    ref_index[-1] = np.asarray(rle_bytes).size
    fm_index[:, -1] = occ_incl[-1].astype(np.uint64)
    return ref_index, fm_index


class RleBWT(BWTBase):
    """Static query engine over a compressed BWT (ref: src/rle_bwt.rs:14-24).

    >>> bwt = RleBWT(device="cpu")
    >>> bwt.load_vector([13, 9, 10, 8, 11, 9, 13, 10, 11, 8])  # {ACGT, TGCA}
    >>> bwt.get_total_size(), bwt.n_runs
    (10, 10)
    >>> bwt.count_kmer([1, 2, 3, 5])  # "ACGT"
    1
    >>> bwt.constrain_range(5, BWTRange(0, 10))  # rows prefixed "T"
    BWTRange(l=8, h=10)
    >>> bwt.count_kmers(np.array([[1, 2, 3, 5], [0, 0, 3, 2]]), [4, 2]).tolist()
    [1, 1]
    """

    # the pair index plus a 6^CACHE_AUTO_K prefix cache are built
    # automatically from this many symbols on (the JAX package's switch;
    # whether the pair tier is the faster one on a given card is measured
    # in PERF.md, and does not change the policy)
    PAIR_AUTO_MIN_SYMBOLS = 32_000_000
    # 6^9: a seeded 21-mer takes ceil((21 - 9) / 2) = 6 pair rounds
    CACHE_AUTO_K = 9
    # the run tier's prefix cache is built in the fused form, up to 6^8
    RUN_CACHE_AUTO_K = 8
    # device bytes the decoded tiers may claim before the policy switches to
    # the run-compressed tier: the JAX package's default, kept until it is
    # set from the card (ROADMAP). Override: MSBWT_TPU_DEVICE_BUDGET_GB.
    DEVICE_BUDGET_GB = 12.0

    def __init__(self, device="cuda", *, bin_power: int = 8):
        # default bin_power 8 (ref: src/rle_bwt.rs:28-29)
        self.device = torch.device(device)
        self.bin_power = bin_power
        self.bwt = np.zeros(0, dtype=np.uint8)  # RLE bytes
        self._standard_init()

    @classmethod
    def with_bin_power(cls, bin_power: int, *, device="cuda") -> "RleBWT":
        """An engine whose parity FM tables sample every ``2^bin_power``
        positions (ref: src/rle_bwt.rs:309-322)."""
        return cls(device, bin_power=bin_power)

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
        n, counts, n_runs = rle_meta(self.bwt)
        self.total_size = n
        self.n_runs = n_runs
        self.symbol_counts = counts.astype(np.uint64)
        csum = np.cumsum(self.symbol_counts)
        self.start_index = (csum - self.symbol_counts).astype(np.uint64)
        self.end_index = csum.astype(np.uint64)
        self._fm = None
        self._host_rank: HostRank | None = None
        self._device_index: rank_ops.OccIndex | None = None
        self._packed_index = None
        self._pair_index = None
        self._run_index = None
        self._kmer_cache = None
        self._cache_k = 0

    # --- parity FM tables, lazy (ref layout, ref: src/rle_bwt.rs:387-467) ---

    @property
    def fm_index(self) -> np.ndarray:
        if self._fm is None:
            self._fm = build_sampled_fm_index(self.bwt, self.bin_power)
        return self._fm[1]

    @property
    def ref_index(self) -> np.ndarray:
        if self._fm is None:
            self._fm = build_sampled_fm_index(self.bwt, self.bin_power)
        return self._fm[0]

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

    def _indexes(self):
        """Both device indexes, derived together from the compressed bytes
        decoded on the device (the host never holds the decoded array)."""
        if self._device_index is None:
            self._device_index, packed = index_from_symbols(
                decode_symbols_device(self.bwt, self.total_size, device=self.device)
            )
            if self._packed_index is None:
                self._packed_index = packed
        return self._device_index, self._packed_index

    @property
    def device_index(self) -> rank_ops.OccIndex:
        """Occurrence index on the device."""
        return self._indexes()[0]

    @property
    def packed_index(self):
        """Packed single-gather rank index (``ops.packed_rank``)."""
        if self._packed_index is None:
            self._indexes()
        return self._packed_index

    def enable_kmer_cache(self, cache_k: int = 8) -> None:
        """Precompute the ranges of all length-``cache_k`` strings so batched
        queries skip their first ``cache_k`` LF steps (the reference's
        unshipped cache idea, ref: src/msbwt_core.rs:133-146)."""
        idx = self.device_index
        self._kmer_cache = rank_ops.build_kmer_cache(
            idx.bwt, idx.occ, idx.starts, idx.n, cache_k
        )
        self._cache_k = cache_k

    def enable_pair_index(self) -> None:
        """Build the 2-step (symbol-pair) index (``ops.pair_rank``, 240 B a
        128-position bin) and route batched queries through it: one row
        gather per bound answers two pattern symbols."""
        self._pair_index = build_pair_index(self.device_index)

    def enable_run_index(self) -> None:
        """Build the run-length-compressed tier (``ops.run_rank``: 2.5 B a
        run + 1/16 B a position) from the RLE bytes, for indexes the
        decoded tiers cannot hold; three dependent gathers a rank."""
        self._run_index = run_rank.build_run_index_from_bytes(self.bwt, device=self.device)

    def _auto_run_tier(self) -> bool:
        """True when the batched path should use the run tier: forced by
        ``MSBWT_TPU_RUN_TIER=1`` (``0`` forbids it), or when the decoded +
        pair tiers would exceed the device budget and the run tier is
        smaller. Like the JAX package's, it prices the decoded + pair tiers
        at 9 B a position even when ``MSBWT_TPU_NO_PAIR`` is set."""
        flag = os.environ.get("MSBWT_TPU_RUN_TIER")
        if flag == "1":
            return True
        if flag == "0":
            return False
        n = self.total_size
        pair_bytes = 9 * n  # decoded u8 (1 B) + pair rows (~8 B) a position
        budget = float(os.environ.get("MSBWT_TPU_DEVICE_BUDGET_GB",
                                      self.DEVICE_BUDGET_GB)) * 1e9
        if pair_bytes <= budget:
            return False
        run_bytes = (run_rank.LANES * 4 * -(-self.n_runs // run_rank.RB)
                     + 4 * (n // run_rank.SP))
        return run_bytes < pair_bytes

    def count_kmers(self, kmers, lengths=None) -> np.ndarray:
        """Batched counts of right-aligned k-mers on the device, through the
        tier the policy picks (module docstring); equal on every tier."""
        big = self.total_size >= self.PAIR_AUTO_MIN_SYMBOLS
        auto_cache = big and not os.environ.get("MSBWT_TPU_NO_CACHE")
        if self._run_index is None and self._pair_index is None and self._auto_run_tier():
            self.enable_run_index()
        if self._run_index is not None:
            if not self._cache_k and auto_cache:
                self._kmer_cache = run_rank.build_kmer_cache_runs(
                    self._run_index, self.RUN_CACHE_AUTO_K)
                self._cache_k = self.RUN_CACHE_AUTO_K
            return run_rank.count_kmers_runs(self._run_index, kmers, lengths,
                                             cache=self._kmer_cache, cache_k=self._cache_k)
        if self._pair_index is None and big and not os.environ.get("MSBWT_TPU_NO_PAIR"):
            self.enable_pair_index()
        if not self._cache_k and auto_cache:
            self.enable_kmer_cache(self.CACHE_AUTO_K)
        if self._pair_index is not None:
            return count_kmers_pair(self._pair_index, kmers, lengths,
                                    cache=self._kmer_cache, cache_k=self._cache_k)
        return count_kmers_packed(self.packed_index, kmers, lengths,
                                  cache=self._kmer_cache, cache_k=self._cache_k)

    # --- query-index packs ---

    def save_query_indexes(self, path: str) -> None:
        """Save the derived query indexes this engine built (pair index,
        packed table, prefix cache) as one ``.npz`` (``utils.checkpoint``);
        a restart loads them with :meth:`load_query_indexes`. The port
        derives the packed table with every device index, so it is saved
        only when no pair index answers the queries; with neither, the
        packed table is derived so that the pack is never empty."""
        from rust_msbwt_tpu_torch.utils.checkpoint import save_query_pack

        pair = self._pair_index
        packed = self._packed_index if pair is None else None
        if packed is None and pair is None:
            packed = self.packed_index
        save_query_pack(path, packed=packed, pair=pair, cache=self._kmer_cache,
                        cache_k=self._cache_k)

    def load_query_indexes(self, path: str) -> None:
        """Install the indexes of a pack saved by either package, on this
        engine's device. The pack must be for the loaded BWT (length and C
        array are checked; ``OSError`` otherwise)."""
        from rust_msbwt_tpu_torch.utils.checkpoint import load_query_pack

        packed, pair, cache, cache_k = load_query_pack(path, device=self.device)
        src = packed if packed is not None else pair
        if src is None:
            raise IOError(f"empty query pack: {path!r}")
        if int(src.n) != self.total_size:
            raise IOError(f"query pack is for a different BWT: n={int(src.n)} "
                          f"!= {self.total_size}")
        want = np.concatenate([self.start_index.astype(np.int64), [self.total_size]])
        if not np.array_equal(src.starts.cpu().numpy().astype(np.int64), want):
            raise IOError("query pack C array mismatch (different BWT)")
        if packed is not None:
            self._packed_index = packed
        if pair is not None:
            self._pair_index = pair
        if cache is not None:
            self._kmer_cache = cache
            self._cache_k = cache_k

    def locate_kmers(self, kmers, lengths=None):
        """Map every k-mer occurrence to ``(query_idx, read_id, offset)``
        (the original msbwt's ``findReadsMatchingSeq``; read ids are
        lexicographic — the id space of ``ops.extract.extract_reads``)."""
        from rust_msbwt_tpu_torch.ops.extract import locate_kmers

        return locate_kmers(self.device_index, kmers, self.get_symbol_count(0),
                            lengths=lengths, packed=self.packed_index)
