"""2-step FM index: backward search two symbols per round (torch).

Port of the JAX package's ``ops.pair_rank`` (the compact 60-lane row only).
For a range end ``l`` and pattern symbols ``s1 s2`` (consumed right to
left, ``s2`` first),

    l2 = C[s1] + rank_{s1}(C[s2] + rank_{s2}(l))
       = C[s1] + D[s1][s2] + rank2_{(s2,s1)}(l)

where ``D[s1][s2] = #{j < C[s2] : BWT[j] = s1}`` is a 6x6 constant and
``rank2`` is rank over the PAIR stream ``PS[i] = (BWT[i] << 3) | BWT[LF(i)]``.
One row gather answers both symbols of a round, so a 21-mer seeded from a
6^9 cache takes 6 rounds of one gather per bound instead of 12.

Row layout, ``table2`` int32 ``[nb, 60]`` per 128-position bin (no terminal
row; bit-exact with the JAX package's default table, so query packs move
between the two packages):

  lanes 0..35   occurrences of each valid pair code before the bin, lane
                ``s * 6 + prev`` for code ``(s << 3) | prev``
  lanes 36..59  bit-plane p (of 6) word l (of 4) at lane 36 + 4p + l: bit k
                of the word is plane-p bit of the pair code at bin position
                32 l + k; positions past n hold the pad code 63

The reader takes row ``min(pos // 128, nb - 1)`` and lets the in-bin offset
run to 128 (a full-bin mask), so a bound ``pos == n`` with ``n % 128 == 0``
reads the last bin whole. (The JAX package's reader gathers row ``n / 128``
there, which does not exist, and counts wrong; the port does not carry
that over.)

Every n-sized pass of the build (the LF of every position, the stream, the
row planes) runs in chunks of ``_PAIR_CHUNK_BINS`` bins, so no temporary
grows with n beyond the table itself; the JAX package's bf16 matmul prefix
sums are integer cumsums here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from rust_msbwt_tpu_torch.ops.alphabet import VC_LEN
from rust_msbwt_tpu_torch.ops.packed_rank import popcount
from rust_msbwt_tpu_torch.ops.rank import BIN, KmerCache, OccIndex, _cache_seed, count_batch

LANES = 60        # int32 lanes per pair-table row
OCC_LANES = 36    # valid pair codes (s * 6 + prev)
PLANE_BASE = 36   # first bit-plane lane
PAD_PAIR = 63     # pad code: never equals a real code (max (5 << 3) | 5 = 45)
_I32 = torch.int32
# bins per chunk of the build's n-sized passes (32M positions: the LF
# gather index is 256 MB of int64 per chunk)
_PAIR_CHUNK_BINS = 1 << 18


class PairIndex(NamedTuple):
    """Device 2-step rank index."""

    table2: torch.Tensor  # int32 [nb, 60]
    starts: torch.Tensor  # int32 [VC_LEN + 1] C-array
    dmat: torch.Tensor    # int32 [36]: D[s1 * 6 + s2]
    n: int


def _build_pair_stream_flat(bwt_padded: torch.Tensor, occ: torch.Tensor,
                            starts: torch.Tensor, *, n: int, b0: int = 0,
                            b1: int | None = None) -> torch.Tensor:
    """``PS[i] = (BWT[i] << 3) | BWT[LF(i)]`` for the positions of bins
    ``[b0, b1)`` (int32, flat), the pad code at ``i >= n``.

    LF comes from the occ checkpoints: ``LF(i) = C[c] + occ[bin(i), c] +``
    the exclusive in-bin count of ``c`` before ``i``, then one gather reads
    ``BWT[LF(i)]``. The in-bin counts of all six symbols come from ONE
    int64 cumsum along the bin, each symbol in its own 8-bit field (a bin
    holds at most 128 of a symbol)."""
    nb = bwt_padded.shape[0] // BIN
    b1 = nb if b1 is None else b1
    bins = bwt_padded.view(nb, BIN)[b0:b1]
    sym = bins.long()
    s = sym.clamp(max=VC_LEN - 1)  # pad positions are masked below
    field = 8 * s
    fields = torch.cumsum(torch.where(sym < VC_LEN, 1 << field, 0), 1)
    excl = ((fields >> field) & 0xFF) - 1
    lf = starts.long()[s] + occ[b0:b1].long().gather(1, s) + excl
    prev = bwt_padded[lf.view(-1).clamp_(0, bwt_padded.shape[0] - 1)]
    ps = (bins.reshape(-1).to(_I32) << 3) | prev.to(_I32)
    pos = torch.arange(b0 * BIN, b1 * BIN, device=bins.device)
    return torch.where(pos < n, ps, PAD_PAIR)


def _build_pair_rows(ps: torch.Tensor) -> torch.Tensor:
    """Rows of a pair stream's bins with the PER-BIN counts of each valid
    code in lanes 0..35 (``_build_pair_table`` turns them into prefixes)."""
    nbins = ps.shape[0] // BIN
    bins = ps.view(nbins, BIN)
    rows = torch.zeros((nbins, LANES), dtype=_I32, device=ps.device)
    # dense lane s * 6 + prev of each code; pad codes land in lane 36
    dense = torch.where(bins == PAD_PAIR, OCC_LANES, (bins >> 3) * VC_LEN + (bins & 7))
    flat = (torch.arange(nbins, device=ps.device)[:, None] * (OCC_LANES + 1) + dense).view(-1)
    hist = torch.bincount(flat, minlength=nbins * (OCC_LANES + 1))
    rows[:, :OCC_LANES] = hist.view(nbins, OCC_LANES + 1)[:, :OCC_LANES]
    w = bins.view(nbins, 4, 32).long()
    k = torch.arange(32, device=ps.device)
    for p in range(6):
        words = (((w >> p) & 1) << k).sum(2)  # int64 in [0, 2^32)
        rows[:, PLANE_BASE + 4 * p: PLANE_BASE + 4 * p + 4] = torch.where(
            words >= 2**31, words - 2**32, words).to(_I32)
    return rows


def _occ_prefix_(table2: torch.Tensor) -> torch.Tensor:
    """Per-bin counts in lanes 0..35 -> occurrences before each bin (in
    place). Each lane is scanned as its own contiguous 1-D tensor: a
    ``cumsum`` along dim 0 of the strided ``[nb, 36]`` view took about
    1.4 s for the table of a 505M-symbol BWT on an H100, where a 1-D scan
    is one device-wide pass."""
    counts = table2[:, :OCC_LANES].T.contiguous()  # [36, nb]
    incl = torch.empty_like(counts)
    for lane in range(OCC_LANES):
        torch.cumsum(counts[lane], 0, dtype=_I32, out=incl[lane])
    table2[:, :OCC_LANES] = (incl - counts).T
    return table2


def _build_pair_table(ps: torch.Tensor) -> torch.Tensor:
    """The ``[nb, 60]`` pair table of a whole pair stream (see the module
    docstring for the row)."""
    return _occ_prefix_(_build_pair_rows(ps))


def _build_dmat(bwt_padded: torch.Tensor, occ: torch.Tensor,
                starts: torch.Tensor) -> torch.Tensor:
    """``D[s1][s2]`` = occurrences of s1 strictly before ``C[s2]``, flat
    ``[36]`` at ``s1 * 6 + s2``: six window gathers + occ rows."""
    nb = bwt_padded.shape[0] // BIN
    c = starts[:VC_LEN].long()
    b = torch.clamp(c // BIN, max=nb - 1)
    r = c - b * BIN
    win = bwt_padded.view(nb, BIN)[b]                                   # [6 s2, BIN]
    in_range = torch.arange(BIN, device=c.device)[None, :] < r[:, None]
    s1 = torch.arange(VC_LEN, dtype=torch.uint8, device=c.device)
    local = ((win[:, :, None] == s1[None, None, :]) & in_range[:, :, None]).sum(1, dtype=_I32)
    return (occ[b] + local).T.reshape(-1).contiguous()                  # D[s1*6 + s2]


def build_pair_index(index: OccIndex) -> PairIndex:
    """Derive the 2-step index from the occurrence index, on its device:
    the pair stream and its rows chunk by chunk, then one cumsum over bins.

    >>> from rust_msbwt_tpu_torch.ops.alphabet import convert_stoi
    >>> from rust_msbwt_tpu_torch.ops.rank import build_occ_index
    >>> pidx = build_pair_index(build_occ_index(convert_stoi("TAC$GATCG$"), device="cpu"))
    >>> tuple(pidx.table2.shape), count_kmers_pair(pidx, convert_stoi("GCA")).tolist()
    ((1, 60), [1])
    """
    bwt = index.bwt
    nb = bwt.shape[0] // BIN
    table2 = torch.empty((nb, LANES), dtype=_I32, device=bwt.device)
    for b0 in range(0, nb, _PAIR_CHUNK_BINS):
        b1 = min(nb, b0 + _PAIR_CHUNK_BINS)
        ps = _build_pair_stream_flat(bwt, index.occ, index.starts, n=index.n, b0=b0, b1=b1)
        table2[b0:b1] = _build_pair_rows(ps)
    return PairIndex(table2=_occ_prefix_(table2), starts=index.starts,
                     dmat=_build_dmat(bwt, index.occ, index.starts), n=index.n)


def _decode_rank(row: torch.Tensor, r: torch.Tensor, code: torch.Tensor,
                 n_planes: int) -> torch.Tensor:
    """Rank from already-gathered rows, ``r`` the in-bin offset (0..128).
    ``n_planes=6`` matches the whole pair code; ``n_planes=3`` only the
    BWT-symbol planes 3..5 (single-symbol rank of ``code``, any prev)."""
    B = code.shape[0]
    code = code.long()
    occ = row[:, :OCC_LANES]
    if n_planes == 6:
        occ_base = occ.gather(1, ((code >> 3) * VC_LEN + (code & 7))[:, None])[:, 0]
        planes = range(6)
    else:
        occ_base = occ.view(B, VC_LEN, VC_LEN).gather(
            1, code[:, None, None].expand(B, 1, VC_LEN)).sum((1, 2), dtype=_I32)
        code = code << 3  # the symbol's bits on planes 3..5
        planes = range(3, 6)
    match = torch.full((B, 4), -1, dtype=_I32, device=row.device)
    for p in planes:
        words = row[:, PLANE_BASE + 4 * p: PLANE_BASE + 4 * p + 4]
        sp = -((code >> p) & 1).to(_I32)  # 0 -> 0x0, 1 -> 0xFFFFFFFF
        match &= ~(words ^ sp[:, None])
    # positions < r of word l (positions 32l .. 32l+31), in int64 so a full
    # word's (1 << 32) - 1 does not overflow
    shift = (r[:, None] - torch.arange(4, device=row.device)[None, :] * 32).clamp(0, 32)
    bits = (match.long() & 0xFFFFFFFF) & ((1 << shift) - 1)
    return occ_base + popcount(bits).sum(1, dtype=_I32)


def kmer_counts_pair_plain(table2, starts, dflat, n: int, kmers: torch.Tensor,
                           lengths: torch.Tensor, cache: KmerCache | None = None,
                           cache_k: int = 0) -> torch.Tensor:
    """Backward search consuming TWO symbols per round; a query with one
    symbol left consumes it from the same gathered row (3-plane decode).
    Each round gathers the rows of ``lo`` and ``hi`` together; a decode no
    query of the batch needs in a round is skipped. The plain twin of the
    ``kmer_counts_pair`` kernel (``ops.query``)."""
    B, K = kmers.shape
    nb = table2.shape[0]
    if table2.shape[1] != LANES:
        raise ValueError(f"pair table rows must be {LANES} lanes, got {table2.shape[1]}")
    lo = torch.zeros(B, dtype=_I32, device=table2.device)
    hi = torch.full((B,), n, dtype=_I32, device=table2.device)
    t_start = 0
    if cache is not None and cache_k > 0 and K >= cache_k:
        lo, hi = _cache_seed(cache, kmers, K, cache_k)
        t_start = cache_k
    lens = set(lengths.unique().tolist())
    for t in range(t_start, K, 2):
        two = any(ln > t + 1 for ln in lens)   # some query has >= 2 symbols left
        one = (t + 1) in lens                   # some query has exactly 1 left
        if not (two or one):
            break
        col2 = K - 1 - t
        s2 = torch.where(t < lengths, kmers[:, col2].to(_I32), 0)
        both = (t + 1) < lengths
        s1 = torch.where(both, kmers[:, max(col2 - 1, 0)].to(_I32), 0)
        pos = torch.cat([lo, hi]).long()
        b = (pos // BIN).clamp_(max=nb - 1)
        rows = table2[b]                          # the one gather per bound
        r = pos - b * BIN                         # 0..128
        new_lo, new_hi = lo, hi
        if one:
            n1 = starts[s2.long()].repeat(2) + _decode_rank(rows, r, s2.repeat(2), 3)
            single = (t < lengths) & ~both
            new_lo = torch.where(single, n1[:B], new_lo)
            new_hi = torch.where(single, n1[B:], new_hi)
        if two:
            d = starts[s1.long()] + dflat[(s1 * VC_LEN + s2).long()]
            n2 = d.repeat(2) + _decode_rank(rows, r, ((s2 << 3) | s1).repeat(2), 6)
            new_lo = torch.where(both, n2[:B], new_lo)
            new_hi = torch.where(both, n2[B:], new_hi)
        lo, hi = new_lo, new_hi
    return hi - lo


def _count_kmers_pair_impl(table2, starts, dflat, n: int, kmers: torch.Tensor,
                           lengths: torch.Tensor, cache: KmerCache | None = None,
                           cache_k: int = 0) -> torch.Tensor:
    """int32 counts of right-aligned k-mers through the pair index: one
    ``kmer_counts_pair`` launch on CUDA tensors, ``kmer_counts_pair_plain``
    on CPU ones."""
    from rust_msbwt_tpu_torch.ops.query import kmer_counts_pair

    return kmer_counts_pair(table2, starts, dflat, n, kmers, lengths, cache, cache_k)


def count_kmers_pair(pidx: PairIndex, kmers, lengths=None, cache=None,
                     cache_k: int = 0) -> np.ndarray:
    """Batched ``count_kmer`` through the 2-step index: ``[B, K]``
    right-aligned uint8 k-mers (numpy) -> int64 counts, equal to
    ``count_kmers_packed``'s (ref semantics: src/msbwt_core.rs:124-161)."""
    def impl(km, ln, c, ck):
        return _count_kmers_pair_impl(pidx.table2, pidx.starts, pidx.dmat, pidx.n,
                                      km, ln, cache=c, cache_k=ck)

    return count_batch(impl, pidx.table2.device, kmers, lengths, cache, cache_k)
