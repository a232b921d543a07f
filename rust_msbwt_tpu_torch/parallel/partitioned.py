"""Partitioned MSBWT: per-rank BWTs that are never merged.

Port of the JAX package's ``parallel.partitioned``. ``count_kmer`` over a
read collection is additive across any disjoint partition of the reads
(every k-mer hit lies inside one read), so counting needs no merge: every
rank builds the BWT of its contiguous group of the sorted reads, keeps the
packed rank table its own build's last merge pass wrote
(``ops.bcr.build_msbwt_with_index``: on a card, the kernel's table), and a
count is a local backward search plus one ``all_reduce`` of the D partial
counts. The JAX package builds the same tables in host numpy after its
build.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.packed_rank import _kmer_ranges_packed_impl
from rust_msbwt_tpu_torch.parallel import mesh

_I32, _I64 = torch.int32, torch.int64


class PartitionedIndex(NamedTuple):
    """This rank's partial BWT, as its packed rank index (never merged)."""

    table: torch.Tensor   # int32 [ceil(size / 128) + 1, 32] packed rank rows
    starts: torch.Tensor  # int32 [VC_LEN + 1] this partial's C array
    size: int             # this partial's BWT length


def build_partitioned(reads: np.ndarray, lengths: np.ndarray, *, device=None) -> PartitionedIndex:
    """Every rank passes the same reads; the reads are sorted, cut into D
    contiguous groups (as ``parallel.sharded_build`` cuts them), and this
    rank builds its group's BWT and packed index on ``device``."""
    from rust_msbwt_tpu_torch.ops.bcr import build_msbwt_with_index
    from rust_msbwt_tpu_torch.parallel.sharded_build import my_group

    if np.asarray(reads).shape[0] == 0:
        raise ValueError("empty read collection")
    g_reads, g_lengths = my_group(reads, lengths)
    _, packed = build_msbwt_with_index(
        g_reads, g_lengths, device=torch.device("cuda" if device is None else device))
    return PartitionedIndex(table=packed.table, starts=packed.starts, size=packed.n)


def count_kmers_partitioned(index: PartitionedIndex, kmers, lengths=None,
                            wide: bool | None = None) -> np.ndarray:
    """Batched ``count_kmer`` over the partitioned index, called by every
    rank with the same right-aligned k-mers: each rank's backward search,
    then one ``all_reduce``. Equals the merged BWT's count for every k-mer
    without ``$``. ``wide`` sums in int64 (default: when the collection
    passes 2^31 symbols).

    >>> import numpy as np
    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> reads = np.stack([convert_stoi("ACGT"), convert_stoi("ACCA")])
    >>> idx = build_partitioned(reads, np.array([4, 4], np.int32), device="cpu")
    >>> [int(c) for c in count_kmers_partitioned(
    ...     idx, np.stack([convert_stoi("AC"), convert_stoi("GT")]))]
    [2, 1]
    """
    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    act = np.arange(K)[None, :] >= (K - lengths)[:, None]  # right-aligned
    if not np.all(~act | ((kmers > 0) & (kmers < VC_LEN))):
        raise ValueError("partitioned counting takes k-mers over 1..5 "
                         "($-queries are position-space; use the merged BWT)")
    dev = index.table.device
    if wide is None:
        total = mesh.all_reduce_sum(torch.tensor([index.size], dtype=_I64, device=dev))
        wide = int(total[0]) >= 2**31
    lo, hi = _kmer_ranges_packed_impl(
        index.table, index.starts, index.size,
        torch.from_numpy(np.ascontiguousarray(kmers)).to(dev),
        torch.from_numpy(lengths).to(dev))
    part = hi - lo
    # one collective: the D partial counts -> the union's counts (a partial
    # is below 2^31; the sum may not be)
    return mesh.all_reduce_sum(part.to(_I64) if wide else part).cpu().numpy()
