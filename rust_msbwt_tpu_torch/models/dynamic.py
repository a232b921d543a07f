"""L2b — the dynamic construction engine (port of the JAX package's
``models.dynamic``).

Same observable behavior as the reference's ``DynamicBWT`` (ref:
src/dynamic_bwt.rs) for building: strings are queued by ``insert_string`` /
``insert_strings`` (sorted or chronological) and materialized in one batch
through ``ops.bcr.build_msbwt_with_index`` on the engine's device, which
also leaves both query indexes there.

Not ported yet: extending an already materialized BWT (a second batch
after a query, a later segment with the other sort flag, ``load_vector``
followed by inserts) raises ``NotImplementedError``; so does loading
(``load_vector`` / ``load_numpy_file``: use ``RleBWT`` to query a saved BWT).
"""

from __future__ import annotations

import logging

import numpy as np
import torch

from rust_msbwt_tpu_torch.models.core import BWTBase, BWTRange, HostRank
from rust_msbwt_tpu_torch.ops import bcr
from rust_msbwt_tpu_torch.ops import rank as rank_ops
from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
from rust_msbwt_tpu_torch.ops.packed_rank import count_kmers_packed

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

    Sorted insertion is input-order independent:

    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_strings(["TGCA", "ACGT"], True)
    >>> bwt.get_symbol_counts().tolist()
    [2, 2, 2, 2, 0, 2]
    """

    def __init__(self, device="cuda"):
        self.device = torch.device(device)
        self._pending: list[tuple[np.ndarray, bool]] = []  # (read, sorted_flag)
        self._index: rank_ops.OccIndex | None = None
        self._packed = None
        self._host_rank: HostRank | None = None
        self._kmer_cache = None
        self._cache_k = 0

    # --- insertion (ref: src/dynamic_bwt.rs:305-381) ---

    def insert_string(self, val, sorted: bool) -> None:
        """Queue a string for insertion; materialized lazily in one batch.

        ``sorted=True`` inserts at the lexicographic position, ``False``
        appends chronologically (ref: src/dynamic_bwt.rs:294-305).
        """
        arr = _encode(val)
        if arr.size and arr.min() == 0:
            raise ValueError("strings must not contain '$' (symbol 0)")
        self.insert_strings([arr], sorted)

    def insert_strings(self, vals, sorted: bool) -> None:
        """Batch insertion entry point."""
        if self._index is not None:
            raise NotImplementedError(
                "extending a materialized BWT is not ported yet"
            )
        self._pending.extend((_encode(v), bool(sorted)) for v in vals)

    def _materialize(self) -> None:
        if self._index is not None:
            return
        flags = {flag for _, flag in self._pending}
        if len(flags) > 1:
            raise NotImplementedError(
                "mixing sorted and chronological inserts needs the extend "
                "flow, which is not ported yet"
            )
        sorted_insert = flags.pop() if flags else True
        batch = [arr for arr, _ in self._pending]
        reads, lengths = bcr.encode_reads(batch)
        self._index, self._packed = bcr.build_msbwt_with_index(
            reads, lengths, sorted_insert=sorted_insert, device=self.device,
        )
        self._pending.clear()
        logger.info(
            "Strings: %d\t(%s batch, BWT size %d)", len(batch),
            "lexicographical" if sorted_insert else "chronological",
            self._index.n,
        )

    # --- views (ref: src/dynamic_bwt.rs:393-430) ---

    def to_vec(self) -> np.ndarray:
        """Decoded BWT, one symbol per entry (ref: src/dynamic_bwt.rs:393-395)."""
        self._materialize()
        return self._index.bwt[: self._index.n].cpu().numpy()

    @property
    def device_index(self) -> rank_ops.OccIndex:
        """The occurrence index the build left on the device."""
        self._materialize()
        return self._index

    @property
    def packed_index(self):
        """The packed rank index the build's last merge pass wrote."""
        self._materialize()
        return self._packed

    def get_symbol_counts(self) -> np.ndarray:
        """All six symbol totals (ref: src/dynamic_bwt.rs:273-277)."""
        return self.device_index.counts.cpu().numpy().astype(np.uint64)

    def get_symbol_count(self, symbol: int) -> int:
        return int(self.get_symbol_counts()[symbol])

    def get_total_size(self) -> int:
        return self.device_index.n

    @property
    def string_count(self) -> int:
        return self.get_symbol_count(0)

    # --- queries ---

    def constrain_range(self, sym: int, input_range: BWTRange) -> BWTRange:
        """Two host rank queries (ref: src/dynamic_bwt.rs:254-259)."""
        if self._host_rank is None:
            self._host_rank = HostRank(self.to_vec())
        c = int(self.device_index.starts[sym])
        return BWTRange(
            l=c + self._host_rank.rank(sym, input_range.l),
            h=c + self._host_rank.rank(sym, input_range.h),
        )

    def enable_kmer_cache(self, cache_k: int = 8) -> None:
        """Precompute the ranges of all length-``cache_k`` strings
        (``cache_k`` <= 8) so batched queries skip their first ``cache_k``
        LF steps."""
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


def create_from_fastx(filenames, sorted: bool = True, *, device="cuda") -> DynamicBWT:
    """Build a BWT from FASTX files on ``device`` (ref:
    src/dynamic_bwt.rs:453-473). Files are parsed on the host; all records
    are inserted as one batch (sorted insertion is order-independent, so
    batching == the reference's record-at-a-time loop)."""
    from rust_msbwt_tpu_torch.utils.fastx import parse_fastx
    from rust_msbwt_tpu_torch.utils.native import parse_fastx_native

    bwt = DynamicBWT(device=device)
    logger.info("Creating BWT from FASTX files...")
    for filename in filenames:
        logger.info('Loading file "%s"...', filename)
        seqs = parse_fastx_native(filename)
        if seqs is None:  # no native toolchain — Python parser
            seqs = [convert_stoi(s) for s in parse_fastx(filename)]
        bwt.insert_strings(seqs, sorted)
        logger.info("Finished loading file with %d sequences.", len(seqs))
    bwt._materialize()
    logger.info(
        "Finished creating BWT, symbol counts: %s",
        bwt.get_symbol_counts().tolist(),
    )
    return bwt
