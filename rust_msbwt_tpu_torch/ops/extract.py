"""Read recovery: the MSBWT is a lossless archive of the read collection
(port of the JAX package's ``ops.extract``).

Read ``i`` (in lexicographic order — the order sorted construction stores
them) is recovered by LF-walking backward from terminator rotation ``i``
(BWT rows 0..n_strings-1 are the ``$`` rotations) until the walk closes the
cycle at ``$``; the symbols visited are the read right-to-left. All
requested reads walk together on the index's device, each to its end in
one launch on the card (``ops.lf.lf_walk_extract``; its plain twin masks
after each read's terminator); the host reads the result once, at the end.
``locate_kmers`` walks every row of each k-mer's range the same way until
it enters the terminator block (``ops.lf.lf_walk_locate``).
"""

from __future__ import annotations

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.bcr import _packed_of, read_lengths_from_bwt
from rust_msbwt_tpu_torch.ops.lf import lf_walk_extract, lf_walk_locate
from rust_msbwt_tpu_torch.ops.packed_rank import PackedOccIndex, _kmer_ranges_packed_impl
from rust_msbwt_tpu_torch.ops.rank import OccIndex


def _walk_bound(index: OccIndex, packed: PackedOccIndex, n_strings: int,
                l_max: int | None) -> int:
    if l_max is None:  # the longest read, recovered from the BWT itself
        l_max = int(read_lengths_from_bwt(index, n_strings, packed).max())
    return max(int(l_max), 1)


def extract_reads(index: OccIndex, ids, n_strings: int, l_max: int | None = None,
                  packed: PackedOccIndex | None = None) -> list[np.ndarray]:
    """Recover reads by index from a BWT. Returns a list of int-encoded reads
    (uint8 arrays, no terminator), in the order of ``ids``.

    ``ids`` index the terminator rotations (0..n_strings-1) — for a sorted
    build that is the lexicographic read order. ``l_max`` bounds the walk
    (defaults to the longest read, recovered from the BWT itself);
    ``packed`` is the index's packed table (derived when not given).

    >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_itos
    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_strings(["GATTACA", "CAT"], sorted=True)
    >>> [convert_itos(r) for r in extract_reads(bwt.device_index, [0, 1], 2)]
    ['CAT', 'GATTACA']
    """
    ids = np.asarray(ids, dtype=np.int32)
    if ids.size == 0:
        return []
    if not np.all((ids >= 0) & (ids < n_strings)):
        raise ValueError(f"read ids must be in [0, {n_strings})")
    packed = _packed_of(index, packed)
    l_max = _walk_bound(index, packed, n_strings, l_max)
    out, done = lf_walk_extract(index.bwt, packed.table, packed.starts,
                              torch.from_numpy(ids).to(index.bwt.device), l_max)
    if not bool(done.all()):
        raise ValueError(f"l_max={l_max} too small: some reads did not close")
    out = out.cpu().numpy()
    return [row[row != 0] for row in out]


def locate_kmers(index: OccIndex, kmers, n_strings: int, lengths=None,
                 l_max: int | None = None, packed: PackedOccIndex | None = None):
    """Map every k-mer occurrence to ``(query, read_id, offset)`` — the
    original msbwt's ``findReadsMatchingSeq``, batched: one backward search
    gives each query's BWT row range, then ALL hit rows LF-walk to their
    terminators together (one packed-rank gather per step).

    Returns three equal-length int32 arrays ``(query_idx, read_id, offset)``
    — read ids are lexicographic (``extract_reads``'s id space), offsets
    are 0-based match starts within the read.

    >>> from rust_msbwt_tpu_torch.models.dynamic import DynamicBWT
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> bwt = DynamicBWT(device="cpu")
    >>> bwt.insert_strings(["ACGTA", "GGACG"], sorted=True)
    >>> q, r, o = locate_kmers(bwt.device_index, [convert_stoi("ACG")], 2)
    >>> sorted(zip(r.tolist(), o.tolist()))   # in read 0 @0, read 1 @2
    [(0, 0), (1, 2)]
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise ValueError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    packed = _packed_of(index, packed)
    dev = packed.table.device
    lo, hi = _kmer_ranges_packed_impl(
        packed.table, packed.starts, packed.n,
        torch.from_numpy(np.ascontiguousarray(kmers)).to(dev), torch.from_numpy(lengths).to(dev),
    )
    lo = lo.cpu().numpy()
    counts = hi.cpu().numpy() - lo
    empty = np.zeros(0, np.int32)
    if counts.sum() == 0:
        return empty, empty, empty
    # flatten every range [lo_i, hi_i) into one walk batch
    qidx = np.repeat(np.arange(B, dtype=np.int32), counts)
    first = np.concatenate([[0], np.cumsum(counts[:-1])]).astype(np.int32)
    pos = np.repeat(lo, counts) + (np.arange(qidx.size, dtype=np.int32)
                                   - np.repeat(first, counts))
    rid, off = lf_walk_locate(
        index.bwt, packed.table, packed.starts,
        torch.from_numpy(pos.astype(np.int32)).to(dev), n_strings,
        _walk_bound(index, packed, n_strings, l_max),
    )
    return qidx, rid.cpu().numpy(), off.cpu().numpy()
