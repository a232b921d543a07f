"""Packed single-gather rank and batched k-mer counting (torch).

Port of the JAX package's ``ops.packed_rank``. Each 128-position bin is one
32-lane int32 row

  lanes 0..5    occ[sym]  — occurrences of sym strictly before the bin
  lanes 8+4p+j  bit-plane p (of 3) word j (of 4): bit k of word j = plane-p
                bit of the symbol at bin position 32 j + k
  other lanes   0

plus one terminal row (occ lanes = totals, planes 0), so that a rank at
``pos == n`` with ``n % 128 == 0`` has a row to read. A rank is ONE row
gather; the in-bin count is XOR + AND + popcount over 12 words. PAD (7) has
all three plane bits set and never equals a queried symbol (0..5).

This is also the exact layout the merge-insert kernel writes for the build
buffer (``ops.merge_insert``), so the build's per-stage rank is
``rank_packed`` on the kernel's table.

Query tiers: the JAX package switches ``count_kmers`` to the pair index at
32M symbols and more. The pair index is not ported yet; the port uses this
packed tier at every size (the JAX package's ``MSBWT_TPU_NO_PAIR=1``
configuration), and the counts are identical.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.rank import BIN, KmerCache, OccIndex, _cache_seed, fetch_counts

ROW = 32  # int32 lanes per packed bin row
_I32 = torch.int32


class PackedOccIndex(NamedTuple):
    """Device rank index: one 128-byte row per 128-symbol bin + terminal row."""

    table: torch.Tensor   # int32 [nb + 1, ROW]
    starts: torch.Tensor  # int32 [VC_LEN + 1]
    n: int                # BWT length

    @property
    def counts(self) -> torch.Tensor:
        return torch.diff(self.starts)


def pack_index(index: OccIndex) -> PackedOccIndex:
    """Build the packed table from an ``OccIndex`` (one pass, on its device).

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.rank import build_occ_index
    >>> idx = build_occ_index(convert_stoi("TAC$GATCG$"), device="cpu")
    >>> pidx = pack_index(idx)
    >>> tuple(pidx.table.shape), int(count_kmers_packed(pidx, convert_stoi("ACGT"))[0])
    ((2, 32), 1)
    """
    from rust_msbwt_tpu_torch.ops.merge_insert import packed_table_plain

    return PackedOccIndex(
        table=packed_table_plain(index.bwt), starts=index.starts, n=index.n
    )


def popcount(x: torch.Tensor) -> torch.Tensor:
    """Per-element popcount of non-negative int64 values below 2^32 (SWAR;
    torch has no popcount op)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = x + (x >> 8)
    x = x + (x >> 16)
    return x & 0x3F


def rank_packed(table: torch.Tensor, sym: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """Batched rank via one packed-row gather per query.

    ``sym`` [B] in 0..5, ``pos`` [B] in [0, n]. Returns int32 occurrences of
    sym in bwt[0:pos].
    """
    sym = sym.long()
    pos = pos.long()
    b = pos // BIN
    r = pos - b * BIN  # in-bin position, 0..127
    row = table[b]  # [B, ROW] — the single gather
    occ_base = row[:, :VC_LEN].gather(1, sym[:, None])[:, 0]
    # plane-match words: ~(plane_p ^ broadcast(bit_p(sym))) AND-ed over planes
    match = torch.full((sym.shape[0], 4), -1, dtype=_I32, device=table.device)
    for p in range(3):
        words = row[:, 8 + 4 * p: 12 + 4 * p]
        sp = -((sym >> p) & 1).to(_I32)  # 0 -> 0x0, 1 -> 0xFFFFFFFF
        match &= ~(words ^ sp[:, None])
    # positions < r mask per word j (positions 32j .. 32j+31), in int64 so a
    # full word's (1 << 32) - 1 does not overflow (bit 31 makes the int32
    # word negative; the & 0xFFFFFFFF reads it as its unsigned bit pattern)
    j32 = torch.arange(4, device=table.device)[None, :] * 32
    shift = (r[:, None] - j32).clamp(0, 32)
    bits = (match.long() & 0xFFFFFFFF) & ((1 << shift) - 1)
    return occ_base + popcount(bits).sum(1, dtype=_I32)


def _kmer_ranges_packed_impl(table, starts, n: int, kmers: torch.Tensor,
                             lengths: torch.Tensor, cache: KmerCache | None = None,
                             cache_k: int = 0):
    """Backward-search every right-aligned k-mer to its BWT row range
    ``[lo, hi)``; a masked fixed-step loop replaces the reference's
    empty-range early exit (an empty range stays empty)."""
    B, K = kmers.shape
    lo = torch.zeros(B, dtype=_I32, device=table.device)
    hi = torch.full((B,), n, dtype=_I32, device=table.device)
    t_start = 0
    if cache is not None and cache_k > 0 and K >= cache_k:
        lo, hi = _cache_seed(cache, kmers, K, cache_k)
        t_start = cache_k
    for t in range(t_start, K):
        active = t < lengths
        s = torch.where(active, kmers[:, K - 1 - t].to(_I32), 0)
        both = rank_packed(table, torch.cat([s, s]), torch.cat([lo, hi]))
        c = starts[s.long()]
        lo = torch.where(active, c + both[:B], lo)
        hi = torch.where(active, c + both[B:], hi)
    return lo, hi


def _count_kmers_packed_impl(table, starts, n: int, kmers, lengths, cache=None,
                             cache_k: int = 0) -> torch.Tensor:
    lo, hi = _kmer_ranges_packed_impl(table, starts, n, kmers, lengths,
                                      cache=cache, cache_k=cache_k)
    return hi - lo


def count_kmers_packed(index: PackedOccIndex, kmers, lengths=None, cache=None,
                       cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer`` over the packed index: ``[B, K]`` right-aligned
    uint8 k-mers (numpy) -> int64 counts (ref semantics:
    src/msbwt_core.rs:124-161). With a ``KmerCache`` of depth ``cache_k``,
    queries of length >= cache_k skip their first cache_k LF steps."""
    from rust_msbwt_tpu_torch.utils.checks import validate_kmers

    kmers = np.asarray(kmers, dtype=np.uint8)
    if kmers.ndim == 1:
        kmers = kmers[None, :]
    if not np.all(kmers < VC_LEN):
        raise ValueError("k-mer symbols must be < 6")
    B, K = kmers.shape
    if lengths is None:
        lengths = np.full(B, K, dtype=np.int32)
    lengths = np.asarray(lengths, dtype=np.int32)
    validate_kmers(kmers, lengths)
    if cache is not None and cache_k > 0 and K >= cache_k:
        short = lengths < cache_k
        if short.any():  # rare path: too short for the cache seed
            out = np.empty(B, dtype=np.int64)
            out[short] = count_kmers_packed(index, kmers[short], lengths[short])
            out[~short] = count_kmers_packed(
                index, kmers[~short], lengths[~short], cache=cache, cache_k=cache_k
            )
            return out
    else:
        cache, cache_k = None, 0
    dev = index.table.device
    out = _count_kmers_packed_impl(
        index.table, index.starts, index.n,
        torch.from_numpy(kmers).to(dev), torch.from_numpy(lengths).to(dev),
        cache=cache, cache_k=cache_k,
    )
    return fetch_counts(out)
