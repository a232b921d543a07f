"""L2b — the dynamic construction engine (port of the JAX package's
``models.dynamic``).

Same observable behavior as the reference's ``DynamicBWT`` (ref:
src/dynamic_bwt.rs): build a BWT by inserting strings (sorted or
chronological), load an existing compressed BWT and extend it, iterate
symbols/runs, and answer the query interface. Insertions are queued and
materialized in batches through ``ops.bcr.build_msbwt_with_index`` on the
engine's device: one batch per run of same-flag inserts, in arrival order,
each extending the BWT the previous batch left on the device (with the
packed index that build wrote, so the extend's terminator search does not
rebuild it). Loading decodes the RLE bytes on the device.
"""

from __future__ import annotations

import logging
import os
from typing import Iterator

import numpy as np
import torch

from rust_msbwt_tpu_torch.models.core import BWTBase, BWTRange, HostRank
from rust_msbwt_tpu_torch.models.rle_bwt import RleBWT
from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.ops import rank as rank_ops
from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed
from rust_msbwt_tpu_torch.ops.pair_rank import build_pair_index, count_kmers_pair
from rust_msbwt_tpu_torch.ops.rle import decode_symbols_device, runs_from_symbols
from rust_msbwt_tpu_torch.utils.npy import load_bwt_bytes

logger = logging.getLogger("rust_msbwt_tpu_torch")


def _encode(val) -> np.ndarray:
    if isinstance(val, (str, bytes)):
        return convert_stoi(val)
    return np.asarray(val, dtype=np.uint8)


class DynamicBWT(BWTBase):
    """Construction-capable BWT (ref: src/dynamic_bwt.rs:24-41) on ``device``.

    Chronological insertion reproduces the reference's ``insert_string``
    doctest (ref: src/dynamic_bwt.rs:295-302):

    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_string("ACGNT", False)
    >>> bwt.to_vec().tolist()
    [5, 0, 1, 2, 3, 4]

    Sorted insertion is input-order independent, across batches too:

    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_string("TGCA", True)
    >>> bwt.get_symbol_counts().tolist()
    [1, 1, 1, 1, 0, 1]
    >>> bwt.insert_string("ACGT", True)
    >>> bwt.get_symbol_counts().tolist()
    [2, 2, 2, 2, 0, 2]
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._pending: list[tuple[np.ndarray, bool]] = []  # (read, sorted_flag)
        self._base: torch.Tensor | None = None  # materialized BWT (None: empty)
        self._base_strings = 0  # '$' count of _base (tracked, no device pass)
        # longest read in _base; None == unknown (recovered by LF walk)
        self._max_read_len: int | None = 0
        self._cache_k = 0  # kept across inserts: the cache is rebuilt lazily
        self._set_base(None)

    @classmethod
    def from_decoded(cls, decoded, *, device="cuda") -> "DynamicBWT":
        """Wrap an already-constructed decoded BWT (host uint8 array or
        tensor). The max read length is unknown, so a later insert recovers
        it by LF walk."""
        bwt = cls(device=device)
        base = bcr._base_symbols(decoded, bwt.device)
        bwt._set_base(base if base.numel() else None)
        bwt._max_read_len = None
        bwt._base_strings = int((base == 0).sum())
        return bwt

    def _set_base(self, base, index=None, packed=None) -> None:
        """Replace the materialized BWT; every index derived from the old one
        goes with it (``index``/``packed`` are the new one's, when known)."""
        self._base = base
        self._index: rank_ops.OccIndex | None = index
        self._packed = packed
        self._pair = None
        self._host_rank: HostRank | None = None
        self._kmer_cache = None  # _cache_k stays: rebuilt at the next query

    # --- insertion (ref: src/dynamic_bwt.rs:305-381) ---

    def insert_string(self, val, sorted: bool) -> None:
        """Queue a string for insertion; materialized lazily in batches.

        ``sorted=True`` inserts at the lexicographic position, ``False``
        appends chronologically (ref: src/dynamic_bwt.rs:294-305).
        """
        arr = _encode(val)
        if arr.size and arr.min() == 0:
            raise ValueError("strings must not contain '$' (symbol 0)")
        self.insert_strings([arr], sorted)

    def insert_strings(self, vals, sorted: bool) -> None:
        """Batch insertion entry point."""
        self._pending.extend((_encode(v), bool(sorted)) for v in vals)

    def _materialize(self) -> None:
        if not self._pending:
            return
        # group consecutive same-flag inserts; each group is one BCR batch
        groups: list[tuple[bool, list[np.ndarray]]] = []
        for arr, flag in self._pending:
            if groups and groups[-1][0] == flag:
                groups[-1][1].append(arr)
            else:
                groups.append((flag, [arr]))
        for flag, batch in groups:
            reads, lengths = bcr.encode_reads(batch)
            rot_max = None if self._max_read_len is None else self._max_read_len + 1
            idx, packed = bcr.build_msbwt_with_index(
                reads, lengths, sorted_insert=flag, base=self._base,
                base_string_count=self._base_strings, base_rot_max=rot_max,
                device=self.device, base_index=self._packed,
            )
            self._set_base(idx.bwt[: idx.n], idx, packed)
            self._base_strings += len(batch)
            batch_max = int(lengths.max())
            self._max_read_len = (batch_max if self._max_read_len is None
                                  else max(self._max_read_len, batch_max))
            logger.info(
                "Strings: %d\t(%s batch of %d, BWT size %d)", self._base_strings,
                "lexicographical" if flag else "chronological", len(batch), idx.n,
            )
        self._pending.clear()

    # --- loading (ref: src/dynamic_bwt.rs:73-207) ---

    def load_vector(self, bwt) -> None:
        """Initialize from a compressed RLE byte vector (ref:
        src/dynamic_bwt.rs:73-118 — there an O(n) reinsert; here one decode
        on the device)."""
        base = decode_symbols_device(np.asarray(bwt, dtype=np.uint8), device=self.device)
        self._pending.clear()
        self._set_base(base if base.numel() else None)
        self._max_read_len = None  # unknown; recovered by LF walk if extended
        self._base_strings = int((base == 0).sum())
        logger.info("Loaded BWT with %d symbols, %d strings", base.numel(),
                    self._base_strings)

    def load_numpy_file(self, filename: str) -> None:
        self.load_vector(load_bwt_bytes(filename))

    # --- views (ref: src/dynamic_bwt.rs:393-430) ---

    def to_vec(self) -> np.ndarray:
        """Decoded BWT, one symbol per entry (ref: src/dynamic_bwt.rs:393-395)."""
        self._materialize()
        if self._base is None:
            return np.zeros(0, dtype=np.uint8)
        return self._base.to("cpu", copy=True).numpy()

    def iter(self) -> Iterator[int]:
        return iter(self.to_vec().tolist())

    def run_iter(self) -> Iterator[tuple[int, int]]:
        """Maximal runs as (symbol, count) (ref: src/dynamic_bwt.rs:417-430)."""
        syms, counts = runs_from_symbols(self.to_vec())
        return zip(syms.tolist(), counts.tolist())

    def _indexes(self):
        self._materialize()
        if self._packed is None:
            base = self._base
            if base is None:
                base = torch.zeros(0, dtype=torch.uint8, device=self.device)
            self._index, self._packed = bcr.index_from_symbols(base)
        return self._index, self._packed

    @property
    def device_index(self) -> rank_ops.OccIndex:
        """The occurrence index of the BWT on the device (the one the last
        build left there, or derived once after a load)."""
        return self._indexes()[0]

    @property
    def packed_index(self):
        """The packed rank index (the last build's merge pass wrote it)."""
        return self._indexes()[1]

    def get_symbol_counts(self) -> np.ndarray:
        """All six symbol totals (ref: src/dynamic_bwt.rs:273-277)."""
        return self.device_index.counts.cpu().numpy().astype(np.uint64)

    def get_symbol_count(self, symbol: int) -> int:
        return int(self.get_symbol_counts()[symbol])

    def get_total_size(self) -> int:
        self._materialize()
        return 0 if self._base is None else int(self._base.numel())

    @property
    def string_count(self) -> int:
        return self.get_symbol_count(0)

    def get_height(self) -> int:
        """Structure-depth telemetry. There is no tree here — the analogue of
        the reference's B+-tree height (ref: src/dynamic_bwt.rs:279-283) is
        the constant depth of the two-level occ index."""
        return 2 if self.get_total_size() else 0

    def get_node_count(self) -> int:
        """Storage-node telemetry: number of maximal runs (the analogue of
        the reference's tree node count, ref: src/dynamic_bwt.rs:285-289)."""
        return int(runs_from_symbols(self.to_vec())[0].size)

    # --- queries ---

    def constrain_range(self, sym: int, input_range: BWTRange) -> BWTRange:
        """Two host rank queries (ref: src/dynamic_bwt.rs:254-259)."""
        self._materialize()
        if self._host_rank is None:
            self._host_rank = HostRank(self.to_vec())
        c = int(self.device_index.starts[sym])
        return BWTRange(
            l=c + self._host_rank.rank(sym, input_range.l),
            h=c + self._host_rank.rank(sym, input_range.h),
        )

    def enable_kmer_cache(self, cache_k: int = 8) -> None:
        """Precompute the ranges of all length-``cache_k`` strings so batched
        queries skip their first ``cache_k`` LF steps; rebuilt lazily after
        inserts and loads."""
        self._cache_k = cache_k
        self._kmer_cache = None
        self._ensure_kmer_cache()

    def _ensure_kmer_cache(self):
        idx = self.device_index
        if self._cache_k and self._kmer_cache is None:
            self._kmer_cache = rank_ops.build_kmer_cache(
                idx.bwt, idx.occ, idx.starts, idx.n, self._cache_k
            )
        return self._kmer_cache

    def count_kmers(self, kmers, lengths=None) -> np.ndarray:
        """Batched counts of right-aligned k-mers on the device. From
        ``RleBWT.PAIR_AUTO_MIN_SYMBOLS`` on, the pair index and a
        6^``CACHE_AUTO_K`` prefix cache answer (``MSBWT_TPU_NO_PAIR`` /
        ``MSBWT_TPU_NO_CACHE`` opt out), both rebuilt lazily after inserts
        and loads; below it, the packed tier. Equal counts on both."""
        big = self.get_total_size() >= RleBWT.PAIR_AUTO_MIN_SYMBOLS
        if not self._cache_k and big and not os.environ.get("MSBWT_TPU_NO_CACHE"):
            self._cache_k = RleBWT.CACHE_AUTO_K
        cache = self._ensure_kmer_cache()
        if big and not os.environ.get("MSBWT_TPU_NO_PAIR"):
            if self._pair is None:
                self._pair = build_pair_index(self.device_index)
            return count_kmers_pair(self._pair, kmers, lengths, cache=cache,
                                    cache_k=self._cache_k)
        return count_kmers_packed(
            self.packed_index, kmers, lengths, cache=cache, cache_k=self._cache_k,
        )

    def locate_kmers(self, kmers, lengths=None):
        """Map every k-mer occurrence to ``(query_idx, read_id, offset)``
        (the original msbwt's ``findReadsMatchingSeq``; read ids are
        lexicographic — the id space of ``ops.extract.extract_reads``)."""
        from rust_msbwt_tpu_torch.ops.extract import locate_kmers

        idx, packed = self._indexes()
        return locate_kmers(idx, kmers, self._base_strings, lengths=lengths,
                            packed=packed)


def _fastx_records(filename):
    from rust_msbwt_tpu_torch.utils.fastx import parse_fastx
    from rust_msbwt_tpu_torch.utils.native import parse_fastx_native

    seqs = parse_fastx_native(filename)
    if seqs is None:  # no native toolchain — Python parser
        seqs = [convert_stoi(s) for s in parse_fastx(filename)]
    return seqs


def create_from_fastx(filenames, sorted: bool = True, *, device="cuda") -> DynamicBWT:
    """Build a BWT from FASTX files on ``device`` (ref:
    src/dynamic_bwt.rs:453-473). Files are parsed on the host; all records
    are inserted as one batch (sorted insertion is order-independent, so
    batching == the reference's record-at-a-time loop)."""
    bwt = DynamicBWT(device=device)
    logger.info("Creating BWT from FASTX files...")
    for filename in filenames:
        logger.info('Loading file "%s"...', filename)
        seqs = _fastx_records(filename)
        bwt.insert_strings(seqs, sorted)
        logger.info("Finished loading file with %d sequences.", len(seqs))
    bwt._materialize()
    logger.info(
        "Finished creating BWT, symbol counts: %s",
        bwt.get_symbol_counts().tolist(),
    )
    return bwt


def create_from_fastx_streaming(filenames, sorted: bool = True,
                                batch_size: int = 100_000, *,
                                device="cuda") -> DynamicBWT:
    """Streaming variant of :func:`create_from_fastx`: reads flow through
    ``utils.streaming.StreamingBuilder`` in ``batch_size`` chunks, so the
    device holds one batch's build plus the accumulated BWT instead of a
    whole file's build."""
    from rust_msbwt_tpu_torch.utils.streaming import StreamingBuilder

    builder = StreamingBuilder(sorted_insert=sorted, device=device)
    logger.info("Creating BWT from FASTX files (streaming)...")
    for filename in filenames:
        logger.info('Loading file "%s"...', filename)
        seqs = _fastx_records(filename)
        for i in range(0, len(seqs), batch_size):
            reads, lengths = bcr.encode_reads(seqs[i: i + batch_size])
            builder.add_batch(reads, lengths)
            logger.info("Processed %d strings (batch of %d)",
                        builder.string_count, reads.shape[0])
    if builder.string_count:
        bwt = DynamicBWT.from_decoded(builder.finish(device_out=True), device=device)
    else:
        bwt = DynamicBWT(device=device)
    logger.info(
        "Finished creating BWT, symbol counts: %s",
        bwt.get_symbol_counts().tolist(),
    )
    return bwt
